"""accel.api.trace_any on connection segments between surface points: share of the bound, %."""
from portbench.harness import readers


def read(reading):
    return readers.roofline_pct(reading, "any")
