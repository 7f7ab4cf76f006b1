"""The clock a driver runs under: set-up end, unit ends, window end.

A timed run (`--trace 0`) measures from the end of set-up for
`seconds` of host time, to the end of the unit that crosses it.  A
traced run (`--trace 1`) runs `trace_units` units under torch.profiler
from the end of set-up instead, and reads the trace of that stretch.
"""
from __future__ import annotations

import time

import numpy as np

from . import trace as trace_mod
from .common import sync


class Clock:
    def __init__(self, t_process: float, seconds: float, device,
                 trace_units: int | None = None):
        self.t_process = t_process
        self.seconds = seconds
        self.device = device
        self.trace_units = trace_units
        self.setup_s = None
        self.t0 = None
        self.stamps: list = []
        self.trace = None
        self.trace_read_s = None
        self._prof = None

    @property
    def traced(self) -> bool:
        return self.trace_units is not None

    def setup_done(self):
        """Set-up is over: the next unit is the window's first."""
        sync(self.device)
        now = time.perf_counter()
        self.setup_s = now - self.t_process
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
        self.t0 = time.perf_counter()

    def unit_done(self) -> bool:
        """A unit has ended (its result is on the host); True once the
        window is over."""
        now = time.perf_counter()
        self.stamps.append(now)
        if not self.traced:
            return now - self.t0 >= self.seconds
        if len(self.stamps) < self.trace_units:
            return False
        sync(self.device)
        wall = time.perf_counter() - self.t0
        self._prof.stop()
        t1 = time.perf_counter()
        self.trace = trace_mod.summarize(trace_mod.events(self._prof), wall)
        self.trace_read_s = time.perf_counter() - t1
        self._prof = None
        return True

    @property
    def units(self) -> int:
        return len(self.stamps)

    @property
    def wall(self) -> float:
        """Seconds from the window's start to its last unit's end."""
        return self.stamps[-1] - self.t0

    def unit_walls(self) -> list:
        return np.diff([self.t0] + self.stamps).tolist()
