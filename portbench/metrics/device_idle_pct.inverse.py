"""Idle share of the device over the traced descent step, %."""
from portbench.harness import readers


def read(reading):
    return readers.idle_pct(reading)
