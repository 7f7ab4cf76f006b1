"""Arithmetic shared by the per-layer metrics' readers
(portbench/metrics/<metric>.py).  Each returns None where the run has
nothing to read, and the harness then leaves the metric out: a trace in
which no operation ran on the device (a CPU run) gives no device
metric."""
from __future__ import annotations


def device_trace(reading):
    """The run's trace, or None where it holds no device time."""
    t = reading.trace
    return t if t is not None and t.busy_s > 0 else None


def per_unit(count, units):
    """count / units, or None without either."""
    if count is None or not units:
        return None
    return count / units


def launches_per(reading, unit: str):
    """Device kernel events of the traced stretch per `unit` of it
    ("samples", "frames", "steps")."""
    t = device_trace(reading)
    return None if t is None else per_unit(t.kernels,
                                           reading.counts.get(unit))


def device_ms_per(reading, unit: str):
    """Device busy milliseconds of the traced stretch per `unit`."""
    t = device_trace(reading)
    return None if t is None else per_unit(1e3 * t.busy_s,
                                           reading.counts.get(unit))


def idle_pct(reading):
    """100 (1 - busy / wall) of the traced stretch."""
    t = device_trace(reading)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(reading, kind: str):
    """The routing entry's share of its bound on the probe of `kind`."""
    p = reading.probe(kind)
    return None if p is None else p["pct"]
