#!/usr/bin/env python3
"""Measure how far runs of one tree spread, as a check reads them.

    python3 portbench/spread.py --workload <cell> --seed <n> --sets 4
        --runs 6 --seconds <s> [--warm 1] [--out <file.jsonl>]

Runs `--sets` sets of `--runs` timed runs of `portbench/run.py` (each a
new process, one after another), named A1, B1, A2, B2, ...: the sets of
a pair (A_k, B_k) take the same seeds, and each pair its own.  `--warm`
runs first (the checkout's build) are recorded apart.  For every run:
each end-to-end metric, `correct`, and its own unit walls (the window's
step or chunk walls): their quartile distance over their median, the
units over twice the median and the share of the window they take.  For
every set and metric: the median and the spread (quartile distance over
the median, `statistics.quantiles(n=4)`), also with the run farthest
from the median left out; for every pair, the gap between its two sets'
medians over the first's.  One JSON line a run (with its unit walls), a
set and a pair goes to `--out`; the same without the walls to standard
output.  The benchmark's own runs
never run this.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    """Quartile distance over the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def trimmed_spread(values) -> float:
    """`spread` with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def wall_stats(walls) -> dict:
    """A run's own unit walls: their spread, and the units over twice the
    median with the share of the window they take."""
    med = statistics.median(walls)
    slow = [w for w in walls if w > 2 * med]
    return {"units": len(walls), "unit_median_s": med,
            "unit_spread": spread(walls) if len(walls) > 1 else 0.0,
            "slow_units": len(slow), "slow_share": sum(slow) / sum(walls)}


def parse(stdout: str, stderr: str) -> dict:
    """The result line, the card and the unit walls that run.py
    printed."""
    line = next(line for line in stderr.splitlines()
                if line.startswith("unit_walls "))
    walls = json.loads(line[len("unit_walls "):].split(" loadavg ")[0])
    card, res = (json.loads(x) for x in stdout.strip().splitlines()[-2:])
    return {"correct": res["correct"], "card": card["card"],
            "plain_calls_on_cuda": res["plain_calls_on_cuda"],
            "walls": walls,
            "metrics": {k: m["value"] for k, m in res["metrics"].items()},
            "compared": {k: c["value"] for k, c in res["compared"].items()},
            **wall_stats(walls)}


def one_run(workload, seed, seconds) -> dict:
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        return {"seed": seed, "rc": out.returncode,
                "stderr": out.stderr[-2000:]}
    return {"seed": seed, "rc": 0, **parse(out.stdout, out.stderr)}


def set_stats(runs) -> dict:
    names = sorted(runs[0]["metrics"])
    return {n: {"median": statistics.median(r["metrics"][n] for r in runs),
                "spread": spread([r["metrics"][n] for r in runs]),
                "trimmed_spread": trimmed_spread([r["metrics"][n]
                                                  for r in runs])}
            for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sets", type=int, default=4)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None

    def emit(record):
        record = {"workload": args.workload, **record}
        print(json.dumps({k: v for k, v in record.items() if k != "walls"}),
              flush=True)
        if out:
            out.write(json.dumps(record) + "\n")
            out.flush()

    for i in range(args.warm):
        emit({"set": "warm", **one_run(args.workload, args.seed - 1 - i,
                                       args.seconds)})
    sets = {}
    for k in range(args.sets):
        name = f"{'AB'[k % 2]}{k // 2 + 1}"
        base = args.seed + (k // 2) * args.runs
        runs = []
        for i in range(args.runs):
            runs.append(one_run(args.workload, base + i, args.seconds))
            emit({"set": name, **runs[-1]})
        good = [r for r in runs if r["rc"] == 0]
        sets[name] = set_stats(good) if len(good) >= 3 else None
        emit({"set": name, "summary": sets[name],
              "failed": len(runs) - len(good),
              "incorrect": sum(not r["correct"] for r in good)})
    for k in range(1, args.sets // 2 + 1):
        a, b = sets.get(f"A{k}"), sets.get(f"B{k}")
        if a and b:
            emit({"pair": k, "gap": {n: (b[n]["median"] - a[n]["median"])
                                     / a[n]["median"] for n in a}})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
