"""The port's own spans and counters, read beside the device trace.

The port marks its layers with `record_function("bpt.<name>")` ranges and
counts lanes while a profiler runs (bpt_tpu_torch/telemetry.py).  Here
those ranges are read from the same event list as harness/trace.py reads
(`trace.events`), with one sorted sweep over a stack of open ranges:

  * `program_spans`: for each program span name, its calls, its summed
    host wall, and the kernels whose launch (the host event of the same
    correlation, as `trace.summarize` finds the backward's) falls in it:
    `launches` and `device_s` where it is the innermost program span open
    at the launch (self), `incl_device_s` where it is open at all.  A
    range counts by time on the host clock, whatever its thread: the
    backward's kernels are launched from autograd's own thread while the
    main thread sits in `bpt.diff.backward`.
  * `idle_gaps`: the gaps between busy device intervals, each named by
    the innermost benchmark span at its middle as `trace.summarize` names
    it, and, where a program span is open there too, as
    `<benchmark span>/<innermost program span>`.

Program spans are never device work: a GPU-side `bpt.` annotation counts
neither as busy time nor as a kernel.  The counters are read from the
port's module, where it has one; each reader returns None where there is
nothing to read (a program without the spans or counters).
"""
from __future__ import annotations

from . import packages
from .trace import NO_SPAN, SPAN_PREFIX, TOP, _is_kernel, _union

PROGRAM_PREFIX = "bpt."


def _work(events):
    """Device events that are work: kernels, copies and fills."""
    return [e for e in events if e.device and not e.annotation
            and not e.name.startswith((SPAN_PREFIX, PROGRAM_PREFIX))]


def _innermost(ranges, points, with_open=False):
    """For each time in `points` (sorted), the innermost of `ranges` (host
    Events sorted by start) open at it: the latest started range not yet
    ended, or None; with `with_open`, (innermost, names of every range
    open there).  One sweep: a stack of the ranges started so far, popped
    from the top once they have ended."""
    stack, out, i = [], [], 0
    for t in points:
        while i < len(ranges) and ranges[i].start <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        inner = stack[-1] if stack else None
        out.append((inner, {r.name for r in stack if r.end >= t})
                   if with_open else inner)
    return out


def program_spans(events) -> dict:
    """{span name: {calls, host_s, launches, device_s, incl_device_s}}
    over the program spans of `events`; {} without any."""
    ranges = sorted((e for e in events if not e.device
                     and e.name.startswith(PROGRAM_PREFIX)),
                    key=lambda e: e.start)
    if not ranges:
        return {}
    out = {}
    for r in ranges:
        s = out.setdefault(r.name, {"calls": 0, "host_s": 0.0,
                                    "launches": 0, "device_s": 0.0,
                                    "incl_device_s": 0.0})
        s["calls"] += 1
        s["host_s"] += (r.end - r.start) / 1e9
    launch = {e.correlation: e.start for e in events
              if not e.device and e.correlation}
    work = sorted(((launch[e.correlation], e) for e in _work(events)
                   if e.correlation in launch), key=lambda p: p[0])
    found = _innermost(ranges, [t for t, _ in work], with_open=True)
    for (_, e), (inner, names) in zip(work, found):
        if inner is None:
            continue
        dur = (e.end - e.start) / 1e9
        s = out[inner.name]
        s["device_s"] += dur
        s["launches"] += _is_kernel(e.name)
        for name in names:
            out[name]["incl_device_s"] += dur
    return out


def idle_gaps(events, top: int | None = TOP) -> list:
    """[[name, seconds]], the `top` most time first (all with None):
    `trace.summarize`'s idle gaps, with the innermost program span at a
    gap's middle appended to its name.  Where the profiler marks every GPU-side `bpt.` range as an
    annotation, the gaps and their total are `trace.summarize`'s."""
    busy = _union((e.start, e.end) for e in _work(events))
    mids = [((e0 + s1) / 2, (s1 - e0) / 1e9)
            for (_, e0), (s1, _) in zip(busy, busy[1:])]
    points = [m for m, _ in mids]

    def ranges(prefix):
        return sorted((e for e in events if not e.device
                       and e.name.startswith(prefix)), key=lambda e: e.start)

    bench = _innermost(ranges(SPAN_PREFIX), points)
    prog = _innermost(ranges(PROGRAM_PREFIX), points)
    gaps: dict = {}
    for (_, sec), b, p in zip(mids, bench, prog):
        name = b.name[len(SPAN_PREFIX):] if b is not None else NO_SPAN
        if p is not None:
            name = f"{name}/{p.name}"
        gaps[name] = gaps.get(name, 0.0) + sec
    return sorted(([k, v] for k, v in gaps.items()),
                  key=lambda kv: -kv[1])[:top]


def summed(spans: dict, names, field: str = "device_s"):
    """`field` summed over the spans in `names` that the trace holds;
    None where it holds none of them."""
    have = [spans[n][field] for n in names if n in spans]
    return sum(have) if have else None


def counters():
    """The port's counters and set-up timers (telemetry.snapshot()), or
    None where the program has no such module."""
    try:
        mod = packages.module(packages.PROGRAM, "telemetry")
    except ModuleNotFoundError as e:
        if e.name not in (packages.PROGRAM, f"{packages.PROGRAM}.telemetry"):
            raise
        return None
    return mod.snapshot()


def counter(name: str):
    """One counter or timer of the port, or None where it has none."""
    c = counters()
    return None if c is None else c.get(name)
