"""The trace reduction (harness/trace.py) and the per-layer readers on
synthetic event lists."""
from __future__ import annotations

import types

import pytest

from portbench.harness import readers
from portbench.harness.trace import NO_SPAN, Event, summarize

MS = 1_000_000  # ns


def _events():
    host = [
        Event("portbench.render_chunk", False, 0, 100 * MS),
        Event("portbench.exr_refresh", False, 60 * MS, 90 * MS),
        Event("cudaLaunchKernel", False, 1 * MS, 2 * MS, correlation=1),
        Event("autograd::engine::evaluate_function: IndexBackward0", False,
              20 * MS, 40 * MS),
        Event("cudaLaunchKernel", False, 21 * MS, 22 * MS, correlation=2),
        Event("cudaLaunchKernel", False, 41 * MS, 42 * MS, correlation=3),
    ]
    dev = [
        Event("k_fwd", True, 5 * MS, 15 * MS, correlation=1),
        Event("k_bwd", True, 25 * MS, 35 * MS, correlation=2),
        Event("k_fwd", True, 30 * MS, 50 * MS, correlation=3),
        Event("Memcpy DtoH (Device -> Pinned)", True, 95 * MS, 97 * MS),
        # A GPU user annotation is a range, not work.
        Event("portbench.render_chunk", True, 0, 100 * MS, annotation=True),
    ]
    return host + dev


def test_busy_is_the_union_of_device_intervals():
    t = summarize(_events(), 0.2)
    # [5,15] + [25,50] + [95,97] ms.
    assert t.busy_s == pytest.approx(0.037)
    assert t.window_s == 0.2
    assert t.kernels == 3            # the copy is not a kernel


def test_device_ops_by_time():
    t = summarize(_events(), 0.2)
    assert t.device_ops[0] == ["k_fwd", pytest.approx(0.030)]
    assert [n for n, _ in t.device_ops] == [
        "k_fwd", "k_bwd", "Memcpy DtoH (Device -> Pinned)"]


def test_idle_gaps_named_by_innermost_span():
    t = summarize(_events(), 0.2)
    gaps = dict(t.idle_gaps)
    # 15-25 ms inside render_chunk only; 50-95 ms has its middle (72.5)
    # inside exr_refresh, the innermost span there.
    assert gaps["render_chunk"] == pytest.approx(0.010)
    assert gaps["exr_refresh"] == pytest.approx(0.045)
    assert NO_SPAN not in gaps


def test_backward_time_counts_kernels_launched_in_backward_ranges():
    t = summarize(_events(), 0.2)
    assert t.backward_s == pytest.approx(0.010)
    ev = [e for e in _events() if not e.name.startswith("autograd")]
    assert summarize(ev, 0.2).backward_s is None


def _reading(trace, **counts):
    return types.SimpleNamespace(trace=trace, counts=counts,
                                 probe=lambda kind: None)


def test_readers():
    t = summarize(_events(), 0.2)
    r = _reading(t, samples=2, frames=3)
    assert readers.launches_per(r, "samples") == 1.5
    assert readers.launches_per(r, "frames") == 1.0
    assert readers.device_ms_per(r, "samples") == pytest.approx(18.5)
    assert readers.idle_pct(r) == pytest.approx(81.5)
    assert readers.launches_per(r, "steps") is None
    assert readers.roofline_pct(r, "closest") is None


def test_no_device_time_gives_no_device_metric():
    host = [e for e in _events() if not e.device]
    r = _reading(summarize(host, 0.2), samples=2)
    assert readers.idle_pct(r) is None
    assert readers.launches_per(r, "samples") is None
    assert readers.device_ms_per(_reading(None, samples=1), "samples") \
        is None
