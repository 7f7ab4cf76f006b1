#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (an entry of BENCHMARK.json's `workloads`) names a
configuration (portbench/configs/<config>.json) and a traffic mix
(portbench/traffic/<traffic>.json), which names its driver
(portbench/drivers/<driver>.py); its limits are portbench/limits/<cell>.json
and each per-layer metric's reader is portbench/metrics/<metric>.py.

`--trace 0` times the window and reports the cell's end-to-end metrics;
`--trace 1` traces a stretch of `trace_units` units with torch.profiler
and reports its per-layer metrics.  Either way the outputs of the timed
path are compared with the plain reference once the window has closed,
and the last line of standard output is one JSON object.  The run fails
(exit code other than 0, no result) without a CUDA card, when the cell
asks for more cards than there are, and when JAX or the JAX package is
loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _applies(metric, cell, reported=None) -> bool:
    """Whether `metric` is read in `cell`: listed there, or, without a
    list, wherever its moved metric (`reported`) is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def program_counters():
    """(kernel launches by wrapper, calls of plain versions on CUDA
    tensors): the port's own counters in ops/trace_*.py, ops/gather.py
    and core/rng.py."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.ops import gather, trace_any, trace_closest

    launches, plain = {}, 0
    for mod in (trace_closest, trace_any, gather, rng):
        for name, fn in vars(mod).items():
            if hasattr(fn, "launches"):
                launches[name] = fn.launches
            plain += getattr(fn, "cuda_calls", 0)
    return launches, plain


class Reading:
    """What a per-layer metric's reader gets."""

    def __init__(self, cell, run, clock):
        self.cell = cell
        self.trace = clock.trace
        self.counts = run.counts()
        self._run = run
        self._probes = {}

    def probe(self, kind):
        """The cell's roofline probe of `kind`, or None where its driver
        has none."""
        if not hasattr(self._run, "probe"):
            return None
        if kind not in self._probes:
            self._probes[kind] = self._run.probe(kind)
            common.log(f"probe {kind}: {json.dumps(self._probes[kind])}")
        return self._probes[kind]


def execute(bench, cell, seed, seconds, trace, device="cuda", ctx=None):
    """One run of `cell` on `device`: set-up, the window (or the traced
    stretch), the metrics, then the comparison with the reference.
    Returns the result object (the last line a run prints).  `ctx`: a
    Context in place of the cell's files (the tests' small sizes)."""
    import torch

    from portbench.harness import compare
    from portbench.harness.clock import Clock

    cuda = torch.device(device).type == "cuda"
    ctx = ctx or common.Context.for_cell(cell["name"], seed, device, bench)
    common.log(f"nvidia-smi before: {common.nvidia_smi()}")
    run = common.load_module("drivers", ctx.traffic["driver"]).Cell(ctx)
    clock = Clock(T_PROCESS, seconds, device,
                  ctx.traffic["trace_units"] if trace else None)
    run.run(clock)
    common.sync(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches, plain_calls = program_counters()
    counts = run.counts()
    common.log(f"nvidia-smi after: {common.nvidia_smi()}")
    common.log(f"setup_s {clock.setup_s} units {clock.units} wall "
               f"{clock.wall} counts {json.dumps(counts)}")
    common.log(f"unit_walls {json.dumps(clock.unit_walls())} loadavg "
               f"{os.getloadavg()}")
    common.log(f"memory_peak_bytes {peak} launches {json.dumps(launches)} "
               f"plain_calls_on_cuda {plain_calls}")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if trace:
        tr = clock.trace
        common.log(f"trace: {tr.kernels} kernels, busy {tr.busy_s} s of "
                   f"{tr.window_s} s, backward {tr.backward_s}, read in "
                   f"{clock.trace_read_s} s")
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        reported = {m["name"] for m in bench["end_to_end"]
                    if _applies(m, cell["name"])}
        reading = Reading(cell["name"], run, clock)
        for m in bench["per_layer"]:
            if not _applies(m, cell["name"], reported):
                continue
            value = common.load_module("metrics", m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": clock.setup_s, **run.end_to_end(clock)}
        for m in bench["end_to_end"]:
            if _applies(m, cell["name"]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    outputs = run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = run.check(outputs)
    common.log(f"check_s {time.perf_counter() - t_check}")
    correct, compared = compare.judge(numbers, ctx.limits)
    common.log(f"plain_calls_on_cuda {plain_calls} (must be 0)")
    for name, c in compared.items():
        common.log(f"compared {name} {c['value']} limit {c['limit']}")
    result = {"correct": correct and plain_calls == 0,
              "attempted": counts["attempted"], "failed": counts["failed"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["plain_calls_on_cuda"] = plain_calls
    if "nrays" in counts:
        result["nrays"] = counts["nrays"]
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    common.cache_env()
    args = _args(argv)
    bench = common.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        common.log(f"unknown workload {args.workload!r}")
        return 2
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        common.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                   f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                   f"device_count={torch.cuda.device_count()}")
        return 3
    result = execute(bench, cell, args.seed, args.seconds, args.trace)
    smi = common.nvidia_smi()
    print(json.dumps({"card": smi, "memory_peak_bytes":
                      result["device"]["memory_peak_bytes"],
                      "nrays": result.get("nrays"),
                      "plain_calls_on_cuda": result["plain_calls_on_cuda"]}),
          flush=True)
    found = common.forbidden_modules()
    if found:
        common.log(f"forbidden modules loaded: {found}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
