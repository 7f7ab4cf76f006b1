"""Device kernel events of the traced BDPT chunk per image sample."""
from portbench.harness import readers


def read(reading):
    return readers.launches_per(reading, "samples")
