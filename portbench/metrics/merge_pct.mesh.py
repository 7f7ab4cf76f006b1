"""Share of rank 0's traced stretch spent in the mesh's merge (the port's
timer mesh.merge_s, parallel/mesh.py: the collectives' host wall with
the device synced before and after, so rank 0's wait for the slowest
rank plus the all_reduce), %; None where the program has no such timer."""
from portbench.harness import readers, spans


def read(reading):
    t = readers.device_trace(reading)
    merge_s = spans.counter("mesh.merge_s")
    if t is None or merge_s is None or t.window_s <= 0:
        return None
    return 100.0 * merge_s / t.window_s
