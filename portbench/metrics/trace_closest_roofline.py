"""accel.api.trace_closest on the cell's jittered camera rays: share of the bound (harness/roofline.py), %."""
from portbench.harness import readers


def read(reading):
    return readers.roofline_pct(reading, "closest")
