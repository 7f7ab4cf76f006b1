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
when read, so counting never waits on the device.  `timed(name)` adds the
host seconds of a one-off set-up phase, profiler or not.  `snapshot()`
reads everything into a plain dict and `reset()` clears it.
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


def add(name: str, n: int) -> None:
    """Add host int `n` to counter `name` while profiling."""
    if active():
        _counts[name] = _counts.get(name, 0) + n


def add_device(name: str, t: torch.Tensor) -> None:
    """Add 0-dim tensor `t` to counter `name` while profiling, without
    reading it."""
    if active():
        _device.setdefault(name, []).append(t)


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
