"""Share of render_chunk's batches in the traced stretch that replayed a
CUDA graph, from the port's counters bdpt.graph.replay, .capture and
.eager (bpt_tpu_torch/integrators/graphs.py), %; None where the program
has none of the three."""
from portbench.harness import spans


def read(reading):
    c = spans.counters()
    if c is None:
        return None
    n = {k: c.get(f"bdpt.graph.{k}", 0) for k in ("replay", "capture",
                                                   "eager")}
    total = sum(n.values())
    return 100.0 * n["replay"] / total if total else None
