"""The port's own spans in one traced benchmark run, and what a span costs.

    env PYTHONPATH=. python3 probes/span_breakdown.py --workload caustic_bdpt \\
        --seed 2147483901 [--span-cost]

Runs a cell as `portbench/run.py --workload <cell> --trace 1` runs it
(`run.execute`: set-up, `trace_units` units under torch.profiler, the
per-layer metrics, the check against the reference), keeps the event list
that the run's trace reduction reads, and reduces it once more with the
port's spans (`portbench/harness/spans.py`).  Prints one JSON object (last
line): the run's own result, the spans table (calls, host s, self
launches, self and inclusive device s), every idle gap entry named
`<benchmark span>/<program span>`, the figures read from them per unit,
the seconds of each reduction, and the device-side `bpt.` ranges by
whether the profiler marked them as annotations.

`--span-cost` first times, with no profiler running, a gated span
(`telemetry.span`), a call through `telemetry.spanned`, and an ungated
`record_function`, each per use on this host.  `--device cpu --small`
rehearses on the CPU at portbench/tests/small.py's sizes.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common  # noqa: E402

RNG = ["bpt.rng"]
COMPACTION = ["bpt.accel.compact", "bpt.accel.uncompact"]
TRACE_CALL = ["bpt.accel.trace_closest", "bpt.accel.trace_any",
              "bpt.accel.compact", "bpt.accel.kernel", "bpt.accel.uncompact"]


def span_cost(n: int = 200_000) -> dict:
    """Host microseconds a use, no profiler running."""
    import torch

    from bpt_tpu_torch import telemetry

    def plain():
        return None

    spanned = telemetry.spanned("rng")(plain)

    def per_use(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) / n * 1e6

    def loop():
        for _ in range(n):
            pass

    def gated():
        for _ in range(n):
            with telemetry.span("rng"):
                pass

    def ungated():
        for _ in range(n):
            with torch.profiler.record_function("bpt.rng"):
                pass

    def calls_plain():
        for _ in range(n):
            plain()

    def calls_spanned():
        for _ in range(n):
            spanned()

    base = per_use(loop)
    call = per_use(calls_plain)
    return {"gated_span_us": per_use(gated) - base,
            "spanned_call_us": per_use(calls_spanned) - call,
            "ungated_record_function_us": per_use(ungated) - base,
            "uses": n}


def figures(spans_tab, gaps, units, busy_s):
    """The per-layer figures that the spans give: rng launches and device
    ms a sample, compaction share, forward ms a step, and checks of the
    reduction (self device time over busy time, named idle share)."""
    from portbench.harness import spans as sp

    f = {}
    samples, steps = units.get("samples"), units.get("steps")
    rng_l = sp.summed(spans_tab, RNG, "launches")
    rng_s = sp.summed(spans_tab, RNG)
    if samples and rng_l is not None:
        f["rng_launches_per_sample.bdpt"] = rng_l / samples
        f["rng_device_ms_per_sample.bdpt"] = 1e3 * rng_s / samples
    comp, call = sp.summed(spans_tab, COMPACTION), sp.summed(spans_tab,
                                                             TRACE_CALL)
    if comp is not None and call:
        f["compaction_pct.trace"] = 100.0 * comp / call
    fwd = sp.summed(spans_tab, ["bpt.diff.forward"], "incl_device_s")
    if steps and fwd is not None:
        f["forward_ms_per_step.inverse"] = 1e3 * fwd / steps
    self_s = sum(v["device_s"] for v in spans_tab.values())
    f["self_device_over_busy_pct"] = 100.0 * self_s / busy_s if busy_s \
        else None
    f["launches_in_spans"] = sum(v["launches"] for v in spans_tab.values())
    f["span_calls_per_unit"] = (
        sum(v["calls"] for v in spans_tab.values())
        / (samples or steps or 1))
    for bench in ("render_chunk", "descent_step"):
        inside = [s for n, s in gaps if n == bench or
                  n.startswith(bench + "/")]
        named = [s for n, s in gaps if n.startswith(bench + "/bpt.")]
        if inside:
            f[f"idle_named_pct.{bench}"] = 100.0 * sum(named) / sum(inside)
    return f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    common.cache_env()
    out = {"card": common.nvidia_smi()}
    if args.span_cost:
        out["span_cost"] = span_cost()

    from portbench import run as run_mod
    from portbench.harness import spans as sp
    from portbench.harness import trace as trace_mod

    run_mod.T_PROCESS = T_PROCESS
    kept = {}
    inner = trace_mod.summarize

    def summarize(events, window_s):
        kept["events"] = events
        t0 = time.perf_counter()
        tr = inner(events, window_s)
        kept["summarize_s"] = time.perf_counter() - t0
        return tr

    trace_mod.summarize = summarize
    bench = common.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    ctx = None
    if args.small:
        from portbench.tests.small import small_context
        ctx = small_context(args.workload, args.seed, bench)
    result = run_mod.execute(bench, cell, args.seed, args.seconds, 1,
                             args.device, ctx)
    events = kept["events"]
    t0 = time.perf_counter()
    tab = sp.program_spans(events)
    t1 = time.perf_counter()
    gaps = sp.idle_gaps(events, top=None)
    t2 = time.perf_counter()
    traffic = (ctx or common.Context.for_cell(args.workload, args.seed,
                                              args.device, bench)).traffic
    units = ({"samples": result["attempted"] * traffic["chunk_spp"]}
             if "chunk_spp" in traffic else {"steps": result["attempted"]})
    dev_ranges = [e for e in events if e.device and e.name.startswith("bpt.")]
    out.update(
        result=result, units=units, spans=tab, idle_gaps_named=gaps,
        figures=figures(tab, gaps, units,
                        result["device"].get("busy_s")),
        reduce_s={"summarize": kept["summarize_s"],
                  "program_spans": t1 - t0, "idle_gaps": t2 - t1},
        events=len(events),
        device_bpt_ranges={"annotation": sum(e.annotation
                                             for e in dev_ranges),
                           "not_annotation": sum(not e.annotation
                                                 for e in dev_ranges)})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
