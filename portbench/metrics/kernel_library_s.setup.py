"""Host seconds the port spent building or loading its kernel library
during set-up (the timer setup.kernel_library_s around
ops/_build.py::library): a checkout's first run builds, later runs
load."""
from portbench.harness import spans


def read(reading):
    return spans.counter("setup.kernel_library_s")
