"""The gather backward kernel (ops/gather.py, csrc/gather_backward.cu)
against its bound and its yardsticks, at the config #5 cell's shapes.

    env PYTHONPATH=. python3 probes/gather_backward.py > gather.json

1. One config #5 descent step (the glass box, 1024x1024, 2 spp, rr_depth 2
   without roulette) records every backward call of the material-table
   gathers: its ids and lane gradients.  Per step: calls, kernel launches,
   lanes, the bytes the sums need (ids and gradients read once, sums
   written once) and their bound at 3.35 TB/s; device ms over the recorded
   calls, from the profiler's kernel durations, of the kernel, of the
   plain version (`index_add_`) and of autograd's default backward of
   `table[ids]` (`index_put_` with accumulate, one call a table: the
   library's sorted-run kernel, indexing_backward_kernel_small_stride).
2. The same three on synthetic inputs: 1,048,576 and 3,145,728 lanes, 8
   materials, 1 and 3 tables, ids in runs (sorted) or scattered.

`--res` and `--device cpu` rehearse the control flow here (no times).
Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bpt_tpu_torch.core import rng  # noqa: E402
from bpt_tpu_torch.diff import grad  # noqa: E402
from bpt_tpu_torch.integrators.bdpt import BDPTConfig  # noqa: E402
from bpt_tpu_torch.ops import gather  # noqa: E402
from bpt_tpu_torch.scene.procedural import cornell_box_scene  # noqa: E402
from portbench.harness.common import nvidia_smi  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def _bytes(ids, grads, m):
    return (ids.numel() * ids.element_size()
            + sum(g.numel() * 4 + m * g.shape[1] * 4 for g in grads))


def _library(ids, grads, m):
    idx = (ids.long(),)
    return [torch.zeros((m, g.shape[1]), device=g.device)
            .index_put_(idx, g, accumulate=True) for g in grads]


def _device_ms(fn, calls, reps):
    """Device ms of fn over every recorded call, mean of `reps` passes
    after one warm pass: the summed durations of the kernels the passes
    launch, from torch.profiler (a CUDA-event wall over back-to-back calls
    would time the host's dispatch of the small ones), and the kernels'
    names."""
    for c in calls:
        fn(*c)
    if not torch.cuda.is_available():
        return None, {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for c in calls:
                fn(*c)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns()
    total = 1e-6 * sum(by_name.values()) / reps
    return total, {k[:60]: 1e-6 * v / reps for k, v in by_name.items()}


def compare(calls, reps_kernel=20, reps_plain=5, reps_library=2):
    lanes = sum(c[0].numel() for c in calls)
    nbytes = sum(_bytes(*c) for c in calls)
    kernel, kernels = _device_ms(gather.gather_rows_backward, calls,
                                 reps_kernel)
    plain_ids = [(c[0].long(), c[1], c[2]) for c in calls]
    plain, _ = _device_ms(gather.gather_rows_backward_plain, plain_ids,
                          reps_plain)
    library, libs = _device_ms(_library, calls, reps_library)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"calls": len(calls), "lanes": lanes, "bytes": nbytes,
            "bound_ms": bound, "kernel_ms": kernel,
            "share_of_bound": None if kernel is None else bound / kernel,
            "plain_ms": plain, "library_ms": library,
            "kernel_split_ms": kernels, "library_split_ms": libs}


def step_calls(res, device):
    """The gather backward calls of one config #5 step: [(ids, grads, m)]."""
    scene, _, cam = cornell_box_scene(res, res, device=device,
                                      right_object="glass_sphere",
                                      sphere_subdiv=1)
    cfg = BDPTConfig(res, res, spp=2, rr_depth=2, no_rr=True)
    cc = cam.device_constants(device)
    params = grad.extract_params(scene)
    with torch.no_grad():
        target = grad.render_with_params(params, scene, cc, cfg,
                                         rng.key(1, device), 2)
    start = {**params, "diffuse": params["diffuse"] * 0.7,
             "emission": params["emission"] * 0.4}
    calls = []
    inner = gather.gather_rows_backward

    def recorded(ids, grads, m):
        calls.append((ids.clone(), [g.contiguous().clone() for g in grads],
                      m))
        return inner(ids, grads, m)

    # The wrapper takes the wrapped function's name, so it holds the count.
    recorded.launches = 0
    gather.gather_rows_backward = recorded
    try:
        grad.loss_and_grad(start, scene, cc, cfg, rng.key(2, device), 2,
                           target)
    finally:
        gather.gather_rows_backward = inner
        # The step's launches, handed back to the kernel's own counter.
        inner.launches += recorded.launches
    return calls


def synthetic(n, m, n_tables, runs, device, seed=7):
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, m, (n,), generator=gen, device=device)
    if runs:
        ids = ids.sort().values
    grads = [torch.randn((n, 3), generator=gen, device=device)
             for _ in range(n_tables)]
    return [(ids.to(torch.int32), grads, m)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"card": nvidia_smi(), "device": args.device}
    calls = step_calls(args.res, args.device)
    out["step"] = compare(calls)
    out["step"]["launches"] = 2 * len(calls)
    out["step"]["tables_per_call"] = [len(c[1]) for c in calls]
    out["step"]["lanes_per_call"] = [c[0].numel() for c in calls]
    del calls
    n_big = 1_048_576 if args.device != "cpu" else 4096
    out["synthetic"] = {
        f"{n}x{t}_{'runs' if runs else 'scattered'}":
            compare(synthetic(n, 8, t, runs, args.device))
        for n in (n_big, 3 * n_big) for t in (1, 3) for runs in (True, False)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
