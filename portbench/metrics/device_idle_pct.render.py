"""Idle share of the device over the traced render stretch, %."""
from portbench.harness import readers


def read(reading):
    return readers.idle_pct(reading)
