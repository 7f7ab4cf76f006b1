"""Rays/s scaling efficiency of the mesh, %: a probe of
drivers/render_chunks_sharded.py after the window, the world's rays/s
over a few sharded chunks against the world size times rank 0's own
rays/s rendering the same samples of the whole image alone through
render_chunk; None off the card."""


def read(reading):
    p = reading.probe("scaling")
    return None if p is None else p["pct"]
