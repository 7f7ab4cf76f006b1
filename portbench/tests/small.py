"""Cells at sizes a CPU test can hold: 16x16 images, 2-spp BDPT chunks,
short controls, and probes off (they need the card)."""
from __future__ import annotations

from portbench.harness import common

SMALL = {"width": 16, "height": 16}


def small_context(cell: str, seed: int, bench=None) -> common.Context:
    ctx = common.Context.for_cell(cell, seed, "cpu", bench)
    ctx.config = {**ctx.config, **SMALL}
    t = dict(ctx.traffic)
    if t["driver"] == "render_chunks":
        t["chunk_spp"] = 2
    ctx.traffic = t
    return ctx


def cells(bench=None) -> list:
    return [w["name"] for w in (bench or common.benchmark())["workloads"]]
