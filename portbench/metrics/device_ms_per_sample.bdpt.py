"""Device busy time of the traced BDPT chunk per image sample, ms."""
from portbench.harness import readers


def read(reading):
    return readers.device_ms_per(reading, "samples")
