"""Device time of the kernels launched inside the autograd engine's
backward ranges in the traced descent step, ms per step."""
from portbench.harness import readers


def read(reading):
    t = readers.device_trace(reading)
    if t is None or t.backward_s is None:
        return None
    return readers.per_unit(1e3 * t.backward_s, reading.counts.get("steps"))
