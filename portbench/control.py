#!/usr/bin/env python3
"""Read the control (and the planted faults) of a cell at its own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--fault <name>]

For each seed, the cell's driver puts the reference in the program's
place, computed one precision below the configuration's (its hits in
bfloat16: reference/bpt/precision.py), or, with `--fault`, in float32
with that fault planted (the faults a driver names in `FAULTS`), and
compares it with the reference as a run compares the program.  Prints
one JSON line a seed: the numbers, their limits and whether they pass;
the control and each fault have to come out not correct.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common, compare  # noqa: E402


def main(argv=None) -> int:
    common.cache_env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        common.log("no CUDA card")
        return 3
    for seed in args.seeds:
        ctx = common.Context.for_cell(args.workload, seed, "cuda")
        cell = common.load_module("drivers", ctx.traffic["driver"]).Cell(ctx)
        t0 = time.perf_counter()
        numbers = cell.control(args.fault)
        ok, compared = compare.judge(numbers, ctx.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "correct": ok,
                          "compared": compared,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
