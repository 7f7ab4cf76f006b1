"""The program spans' reduction (harness/spans.py) and the readers of the
port's counters, on synthetic event lists beside harness/trace.py's."""
from __future__ import annotations

import types
from unittest import mock

import pytest

from portbench.harness import common, packages, spans
from portbench.harness.trace import Event, summarize

MS = 1_000_000  # ns


def _launch(t, corr):
    return Event("cudaLaunchKernel", False, int(t * MS), int(t * MS) + 1000,
                 correlation=corr)


def _events(unflagged=True):
    """A render chunk: the benchmark span, the port's nested spans, one
    launch in each and a copy; GPU-side annotations of the spans (one not
    marked as an annotation, with `unflagged`)."""
    host = [
        Event("portbench.render_chunk", False, 0, 100 * MS),
        Event("bpt.bdpt.render_chunk", False, 1 * MS, 99 * MS),
        Event("bpt.bdpt.walks", False, 10 * MS, 50 * MS),
        Event("bpt.rng", False, 12 * MS, 20 * MS),
        Event("bpt.accel.trace_closest", False, 30 * MS, 45 * MS),
        Event("bpt.accel.compact", False, 31 * MS, 35 * MS),
        Event("bpt.count", False, int(35.5 * MS), int(35.9 * MS)),
        Event("bpt.accel.kernel", False, 36 * MS, 40 * MS),
        _launch(0.5, 5), _launch(13, 1), _launch(32, 2), _launch(35.6, 6),
        _launch(37, 3), _launch(55, 4), _launch(96, 7),
    ]
    dev = [
        Event("k_outside", True, 2 * MS, 3 * MS, correlation=5),
        Event("k_rng", True, 14 * MS, 16 * MS, correlation=1),
        Event("k_sort", True, 33 * MS, 36 * MS, correlation=2),
        Event("k_count", True, int(36.5 * MS), 37 * MS, correlation=6),
        Event("K1", True, 38 * MS, 42 * MS, correlation=3),
        Event("k_add", True, 56 * MS, 57 * MS, correlation=4),
        Event("Memcpy DtoH (Device -> Pinned)", True, 96 * MS, 97 * MS,
              correlation=7),
        Event("portbench.render_chunk", True, 0, 100 * MS, annotation=True),
        Event("bpt.bdpt.walks", True, 10 * MS, 50 * MS, annotation=True),
    ]
    if unflagged:
        dev.append(Event("bpt.rng", True, 14 * MS, 16 * MS))
    return host + dev


def _bare(events):
    return [e for e in events if not e.name.startswith("bpt.")]


def test_program_spans_are_never_work():
    work = spans._work(_events())
    assert all(not e.name.startswith(("bpt.", "portbench.")) for e in work)
    assert len(work) == 7
    # With the GPU-side ranges marked as annotations, the benchmark's own
    # reduction reads the same busy time and kernels with or without the
    # program's spans.
    with_spans = summarize(_events(unflagged=False), 0.2)
    assert with_spans == summarize(_bare(_events()), 0.2)
    assert with_spans.kernels == 6
    assert with_spans.busy_s == pytest.approx(0.0125)


def test_self_attribution_with_nested_spans():
    s = spans.program_spans(_events())
    expect = {  # (calls, launches, self ms, inclusive ms)
        "bpt.bdpt.render_chunk": (1, 1, 2.0, 11.5),
        "bpt.bdpt.walks": (1, 0, 0.0, 9.5),
        "bpt.rng": (1, 1, 2.0, 2.0),
        "bpt.accel.trace_closest": (1, 0, 0.0, 7.5),
        "bpt.accel.compact": (1, 1, 3.0, 3.0),
        "bpt.count": (1, 1, 0.5, 0.5),
        "bpt.accel.kernel": (1, 1, 4.0, 4.0),
    }
    assert set(s) == set(expect)
    for name, (calls, launches, self_ms, incl_ms) in expect.items():
        got = s[name]
        assert got["calls"] == calls and got["launches"] == launches, name
        assert got["device_s"] == pytest.approx(self_ms / 1e3), name
        assert got["incl_device_s"] == pytest.approx(incl_ms / 1e3), name
    assert s["bpt.bdpt.walks"]["host_s"] == pytest.approx(0.040)
    # Everything launched inside a program span is in exactly one self
    # figure; the launch at 0.5 ms lies in none.
    assert sum(v["device_s"] for v in s.values()) == pytest.approx(0.0115)
    assert spans.summed(s, ["bpt.accel.compact", "bpt.accel.kernel",
                            "bpt.none"]) == pytest.approx(0.007)
    assert spans.summed(s, ["bpt.none"]) is None


def test_calls_and_host_time_add_up_over_ranges():
    ev = _events() + [Event("bpt.rng", False, 60 * MS, 62 * MS),
                      _launch(61, 8),
                      Event("k_rng", True, 63 * MS, 64 * MS, correlation=8)]
    s = spans.program_spans(ev)["bpt.rng"]
    assert s["calls"] == 2 and s["launches"] == 2
    assert s["host_s"] == pytest.approx(0.010)
    assert s["device_s"] == pytest.approx(0.003)


def test_backward_launches_count_by_time():
    """Kernels launched from another thread while the main thread sits in
    a span are that span's (the events carry no thread)."""
    ev = [Event("bpt.diff.forward", False, 0, 10 * MS),
          Event("bpt.diff.backward", False, 10 * MS, 40 * MS),
          Event("autograd::engine::evaluate_function: IndexBackward0",
                False, 12 * MS, 30 * MS),
          _launch(5, 1), _launch(15, 2),
          Event("k_fwd", True, 6 * MS, 8 * MS, correlation=1),
          Event("k_bwd", True, 16 * MS, 36 * MS, correlation=2)]
    s = spans.program_spans(ev)
    assert s["bpt.diff.forward"]["incl_device_s"] == pytest.approx(0.002)
    assert s["bpt.diff.backward"]["device_s"] == pytest.approx(0.020)
    assert s["bpt.diff.backward"]["device_s"] == pytest.approx(
        summarize(ev, 0.05).backward_s)


def test_gaps_named_by_benchmark_and_program_span():
    gaps = dict(spans.idle_gaps(_events()))
    expect = {"render_chunk/bpt.bdpt.render_chunk": 50.0,
              "render_chunk/bpt.bdpt.walks": 31.0,
              "render_chunk/bpt.accel.kernel": 1.5}
    assert set(gaps) == set(expect)
    for name, ms in expect.items():
        assert gaps[name] == pytest.approx(ms / 1e3), name
    old = summarize(_events(unflagged=False), 0.2).idle_gaps
    assert old == [["render_chunk", pytest.approx(0.0825)]]
    assert sum(gaps.values()) == pytest.approx(old[0][1])
    assert spans.idle_gaps(_events(), top=1) == [
        ["render_chunk/bpt.bdpt.render_chunk", pytest.approx(0.050)]]
    assert len(spans.idle_gaps(_events(), top=None)) == 3


def test_without_program_spans_nothing_changes():
    ev = _bare(_events())
    assert spans.program_spans(ev) == {}
    assert spans.idle_gaps(ev) == summarize(ev, 0.2).idle_gaps


def test_counters_read_the_port_and_none_without_it():
    assert isinstance(spans.counters(), dict)
    with mock.patch.object(packages, "PROGRAM", "no_such_program_pkg"):
        assert spans.counters() is None
        assert spans.counter("setup.scene_build_s") is None
        for name in ("live_lane_pct.trace", "kernel_library_s.setup",
                     "scene_build_s.setup"):
            reading = types.SimpleNamespace(trace=None, counts={})
            assert common.load_module("metrics", name).read(reading) is None


@pytest.mark.parametrize("snap, pct", [
    ({"trace.lanes.closest": 300, "trace.live.closest": 240,
      "trace.lanes.any": 100, "trace.live.any": 20}, 65.0),
    ({"trace.lanes.closest": 10, "trace.live.closest": 10}, 100.0),
    ({"setup.scene_build_s": 0.5}, None),
])
def test_live_lane_reader(snap, pct):
    reader = common.load_module("metrics", "live_lane_pct.trace")
    with mock.patch.object(spans, "counters", lambda: snap):
        got = reader.read(types.SimpleNamespace(trace=None, counts={}))
    assert got == (None if pct is None else pytest.approx(pct))


def test_setup_timer_readers():
    snap = {"setup.kernel_library_s": 0.25, "setup.scene_build_s": 1.5}
    r = types.SimpleNamespace(trace=None, counts={})
    with mock.patch.object(spans, "counters", lambda: snap):
        assert common.load_module("metrics", "kernel_library_s.setup"
                                  ).read(r) == 0.25
        assert common.load_module("metrics", "scene_build_s.setup"
                                  ).read(r) == 1.5
