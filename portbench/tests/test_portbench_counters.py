"""The gate `plain_calls_on_cuda` counts every plain route of the port:
a plain version called with CUDA-flagged inputs shows in
`run.program_counters`, and a run in which it does is not correct."""
from __future__ import annotations

import pytest
import torch

from portbench import run as run_mod


class _CudaFlagged:
    """Stands in for a CUDA tensor where only `is_cuda` is read."""

    is_cuda = True


def _rng_plain(name):
    from bpt_tpu_torch.core import rng

    fn = getattr(rng, name)
    return fn, lambda: rng._count_plain(fn, _CudaFlagged())


def _gather_plain():
    from bpt_tpu_torch.ops import gather

    fn = gather.gather_rows_backward_plain
    return fn, lambda: fn(_CudaFlagged(), (), 0)


def _trace_plain(module, name):
    from bpt_tpu_torch.ops import trace_any, trace_closest

    fn = getattr({"closest": trace_closest, "any": trace_any}[module], name)

    def call():
        fn.cuda_calls += 1

    return fn, call


ROUTES = {
    "fold_in_plain": lambda: _rng_plain("fold_in_plain"),
    "uniform1_plain": lambda: _rng_plain("uniform1_plain"),
    "uniform2_plain": lambda: _rng_plain("uniform2_plain"),
    "gather_rows_backward_plain": _gather_plain,
    "closest_hit_plain": lambda: _trace_plain("closest", "closest_hit_plain"),
    "any_hit_plain": lambda: _trace_plain("any", "any_hit_plain"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plain_call_on_cuda_is_counted(route, monkeypatch):
    fn, call = ROUTES[route]()
    monkeypatch.setattr(fn, "cuda_calls", fn.cuda_calls)
    before = run_mod.program_counters()[1]
    call()
    assert run_mod.program_counters()[1] == before + 1


def test_plain_calls_on_the_cpu_are_not_counted():
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.ops import gather

    before = run_mod.program_counters()[1]
    keys = rng.key(7, "cpu")[None, :]
    rng.uniform2_plain(rng.fold_in_plain(keys, 3))
    rng.uniform1_plain(keys)
    gather.gather_rows_backward_plain(torch.zeros(2, dtype=torch.int64),
                                      (torch.ones(2, 1),), 1)
    assert run_mod.program_counters()[1] == before


def test_launch_counters_are_read():
    launches = run_mod.program_counters()[0]
    assert {"closest_hit", "any_hit", "gather_rows_backward"} <= set(launches)


def test_run_with_a_plain_call_on_cuda_is_not_correct(monkeypatch):
    """A descent run in which every RNG call reads as the plain route on a
    CUDA tensor: its numbers are the program's own, the gate fails it."""
    from bpt_tpu_torch.core import rng

    from portbench.tests.test_portbench_control import _execute

    def flagged(fn, keys):
        fn.cuda_calls += 1

    for name in ("fold_in_plain", "uniform1_plain", "uniform2_plain"):
        fn = getattr(rng, name)
        monkeypatch.setattr(fn, "cuda_calls", fn.cuda_calls)
    monkeypatch.setattr(rng, "_count_plain", flagged)
    res = _execute("inverse_step")
    assert res["plain_calls_on_cuda"] > 0 and not res["correct"]
    assert all(c["value"] <= c["limit"] for c in res["compared"].values())
