"""The port's spans and counters.

`span(name)` marks a stretch of the port's host code as
`torch.profiler.record_function("bpt." + name)` while a profiler runs, so
the span lies on the profiler's own timeline beside the kernels launched
inside it.  With no profiler running it returns one shared null context:
the check is one C call, where an ungated `record_function` costs several
microseconds a use.  `spanned(name)` puts a span around every call of a
function.

The counters count only while a profiler runs, so they cover exactly the
stretch that a device trace covers.  `add` takes host ints; `add_device`
takes 0-dim device tensors, which are kept as they are and summed only
when read, so counting never waits on the device.  Inside `recording()`
(a batch being captured into a CUDA graph, integrators/graphs.py) every
count goes into a `Record` instead, profiler or not, and each replay of
the graph adds it again through `Record.replay` while a profiler runs.
`timed(name)` adds the host seconds of a one-off set-up phase, profiler
or not.  `snapshot()` reads everything into a plain dict and `reset()`
clears it.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

PREFIX = "bpt."

# True while a profiler records (torch.profiler or the autograd profiler).
active = torch.autograd._profiler_enabled

_NULL = contextlib.nullcontext()
_counts: dict = {}
_device: dict = {}
_seconds: dict = {}
_record = None  # the Record of a batch being captured, else None


def span(name: str):
    """`record_function("bpt." + name)` while profiling, else a no-op."""
    if active():
        return torch.profiler.record_function(PREFIX + name)
    return _NULL


def spanned(name: str):
    """Decorator: `span(name)` around every call."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def counting() -> bool:
    """Whether a count added now is kept: while profiling or recording."""
    return _record is not None or active()


def add(name: str, n: int) -> None:
    """Add host int `n` to counter `name` while profiling (to the open
    Record while recording)."""
    if _record is not None:
        _record.counts[name] = _record.counts.get(name, 0) + n
    elif active():
        _counts[name] = _counts.get(name, 0) + n


def add_device(name: str, t: torch.Tensor) -> None:
    """Add 0-dim tensor `t` to counter `name` while profiling (to the open
    Record while recording), without reading it."""
    if _record is not None:
        _record.device.setdefault(name, []).append(t)
    elif active():
        _device.setdefault(name, []).append(t)


class Record:
    """The counts added while a batch was captured into a CUDA graph:
    host ints by name, and device counts as the graph's own tensors, which
    each replay rewrites."""

    def __init__(self):
        self.counts: dict = {}
        self.device: dict = {}

    def replay(self) -> None:
        """Add the recorded counts once more, as the batch run eagerly
        would, while profiling: each device count as its sum at this
        replay (in a span `count`, as accel/api.py's counting)."""
        if not active():
            return
        for name, n in self.counts.items():
            _counts[name] = _counts.get(name, 0) + n
        with span("count"):
            for name, ts in self.device.items():
                _device.setdefault(name, []).append(torch.stack(ts).sum())


@contextlib.contextmanager
def recording():
    """Send every count added in the block, profiler or not, to a new
    Record (yielded) in place of the counters."""
    global _record
    outer, rec = _record, Record()
    _record = rec
    try:
        yield rec
    finally:
        _record = outer


@contextlib.contextmanager
def timed(name: str):
    """Add the host seconds of the block (or decorated call) to `name`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _seconds[name] = _seconds.get(name, 0.0) + time.perf_counter() - t0


def snapshot() -> dict:
    """Every counter and timer: ints for counts, floats for seconds."""
    out = dict(_counts)
    for name, ts in _device.items():
        out[name] = torch.stack(ts).sum().item()
    out.update(_seconds)
    return out


def reset() -> None:
    _counts.clear()
    _device.clear()
    _seconds.clear()
