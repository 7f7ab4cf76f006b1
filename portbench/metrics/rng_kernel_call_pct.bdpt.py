"""Share of the RNG calls (core/rng.py's fold_in, uniform1, uniform2) in
the traced stretch that took the threefry kernel, from the port's counters
rng.calls.kernel and rng.calls.plain (bpt_tpu_torch/telemetry.py), %;
None where the program has neither counter."""
from portbench.harness import spans


def read(reading):
    c = spans.counters()
    if c is None:
        return None
    kernel = c.get("rng.calls.kernel", 0)
    plain = c.get("rng.calls.plain", 0)
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
