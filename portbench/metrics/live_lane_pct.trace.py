"""Share of the lanes handed to accel.api's traces in the traced stretch
that were live (max_t >= min_t), from the port's counters trace.lanes.*
and trace.live.* (bpt_tpu_torch/telemetry.py), %."""
from portbench.harness import spans


def read(reading):
    c = spans.counters()
    if c is None:
        return None
    lanes = sum(c.get(f"trace.lanes.{k}", 0) for k in ("closest", "any"))
    live = sum(c.get(f"trace.live.{k}", 0) for k in ("closest", "any"))
    return 100.0 * live / lanes if lanes else None
