"""Reading the profiler's device trace.

The event reading is copied from chip_smoke.py::_profile_run (the raw
`kineto_results.events()`, not `key_averages()`, which builds a Python
object for every event first: 38-46 s for one path tracer sample on an
H100), with one change: busy time and wall come from the same traced
stretch.  Busy time is the union of the device intervals of kernels,
copies and fills (a GPU user annotation is a range, not work, and is
left out).  Each idle gap between device intervals is named by the
innermost benchmark span (`portbench.*`) active on the host at its
middle.  Backward device time is that of the kernels whose launch lies
inside one of the autograd engine's `evaluate_function` ranges.
"""
from __future__ import annotations

import bisect
import dataclasses

SPAN_PREFIX = "portbench."
BACKWARD_PREFIX = "autograd::engine::evaluate_function"
NO_SPAN = "(outside any benchmark span)"
TOP = 10


@dataclasses.dataclass
class Event:
    """One event as the reader needs it (ns on the profiler's clock)."""

    name: str
    device: bool
    start: int
    end: int
    correlation: int = 0
    annotation: bool = False


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: int                 # device kernel events
    device_ops: list             # [[name, seconds]], most time first
    idle_gaps: list              # [[span, seconds]], most time first
    backward_s: float | None     # None: no backward range in the trace


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged, t) -> bool:
    i = bisect.bisect_right([s for s, _ in merged], t) - 1
    return i >= 0 and t <= merged[i][1]


def summarize(events, window_s: float) -> Trace:
    """Reduce `events` (Event) of one traced stretch of `window_s` host
    seconds."""
    dev = [e for e in events if e.device and not e.annotation
           and not e.name.startswith(SPAN_PREFIX)]
    host = [e for e in events if not e.device]
    busy = _union((e.start, e.end) for e in dev)
    busy_s = sum(e - s for s, e in busy) / 1e9

    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start) / 1e9
    device_ops = sorted(([k, v] for k, v in by_name.items()),
                        key=lambda kv: -kv[1])[:TOP]

    spans = sorted((e for e in host if e.name.startswith(SPAN_PREFIX)),
                   key=lambda e: e.start)
    gaps: dict = {}
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        inner = [sp for sp in spans if sp.start <= mid <= sp.end]
        name = (max(inner, key=lambda sp: sp.start).name[len(SPAN_PREFIX):]
                if inner else NO_SPAN)
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e9
    idle_gaps = sorted(([k, v] for k, v in gaps.items()),
                       key=lambda kv: -kv[1])[:TOP]

    backward = _union((e.start, e.end) for e in host
                      if e.name.startswith(BACKWARD_PREFIX))
    backward_s = None
    if backward:
        launch = {e.correlation: e.start for e in host if e.correlation}
        backward_s = sum((e.end - e.start) / 1e9 for e in dev
                         if _is_kernel(e.name) and e.correlation in launch
                         and _covered(backward, launch[e.correlation]))
    return Trace(busy_s=busy_s, window_s=window_s,
                 kernels=sum(1 for e in dev if _is_kernel(e.name)),
                 device_ops=device_ops, idle_gaps=idle_gaps,
                 backward_s=backward_s)


def events(prof):
    """Event records from the profiler's raw kineto results."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        device = ev.device_type() == cuda
        corr = ev.linked_correlation_id() if device else 0
        out.append(Event(name=ev.name(), device=device, start=ev.start_ns(),
                         end=ev.start_ns() + ev.duration_ns(),
                         correlation=(corr or ev.correlation_id()),
                         annotation=ev.is_user_annotation()))
    return out
