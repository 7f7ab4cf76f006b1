"""Share of render_chunk's batches in the traced stretch that replayed a
CUDA graph, summed over every rank of the mesh: rank 0's counters
bdpt.graph.replay, .capture and .eager (bpt_tpu_torch/integrators/
graphs.py) and those the other ranks report to rank 0, %; None
where the program has none of them."""
from portbench.harness import spans

KINDS = ("replay", "capture", "eager")


def read(reading):
    c = spans.counters()
    others = reading.counts.get("graph_other_ranks")
    if c is None or others is None:
        return None
    n = {k: c.get(f"bdpt.graph.{k}", 0) + others.get(k, 0) for k in KINDS}
    total = sum(n.values())
    return 100.0 * n["replay"] / total if total else None
