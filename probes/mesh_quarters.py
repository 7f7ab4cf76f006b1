"""caustic_bdpt_mesh4's program side on one card, without the mesh.

    env PYTHONPATH=. python3 probes/mesh_quarters.py --seeds 2147491003 \\
        2147491105

For each seed, one 16-spp chunk of the cell (at an offset drawn from the
seed) is rendered as the cell's four ranks render it, but one quarter
after another in this process: `render_chunk` over pixel shard (i, dp) at
the configuration's samples a batch, the four framebuffers and ray counts
summed (what the mesh's all_reduce sums, up to float order).  The sum is
compared with the cell's own reference (`drivers/render_chunks_sharded.py`:
the plain whole-image render of the same samples), as a run compares rank
0's merged chunk.  Then each quarter's chunk, replayed, and the whole
image's at the driver's one-card batch are timed (best of 3, device
synced): `bound_pct`, 100 x whole / (dp x slowest quarter), is the
scaling share the device time alone allows.  Prints one JSON line a seed.
`--device cpu --small` rehearses on the CPU at portbench/tests/small.py's
sizes.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

CELL = "caustic_bdpt_mesh4"


def _timed(fn, sync, reps=3):
    """(best seconds of `reps` calls after a first, nrays of the last)."""
    fn()
    sync()
    best, nr = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        _, nr = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, int(nr)


def quarters(seed: int, device: str, small: bool) -> dict:
    from portbench.harness import common, packages
    from portbench.tests.small import small_context

    drv = common.load_module("drivers", "render_chunks_sharded")
    bdpt = packages.module(packages.PROGRAM, "integrators.bdpt")
    ctx = (small_context(CELL, seed) if small
           else common.Context.for_cell(CELL, seed, device))
    cell = drv.Cell(ctx)
    b = cell._build(packages.PROGRAM)
    dp, sb = ctx.config["mesh"]["dp"], ctx.config["samples_per_batch"]
    spp = ctx.traffic["chunk_spp"]
    off = spp * (1 + seed % 7)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def chunk(shard=None):
        extra = ({"samples_per_batch": b["sb"]} if shard is None else
                 {"samples_per_batch": sb, "pixel_shard": (shard, dp)})
        return bdpt.render_chunk(b["scene"], b["cc"], b["cfg"], b["key"], spp,
                                 sample_offset=off, **extra)

    fb, nrays = 0, 0
    for i in range(dp):
        f, n = chunk(i)
        fb, nrays = fb + f.cpu().numpy(), nrays + int(n)
    shard = [_timed(lambda: chunk(i), sync) for i in range(dp)]
    whole = _timed(chunk, sync)
    b = None
    got = cell.compared([(off, fb, nrays)], cell.reference_records([off]))
    return {"seed": seed, "offset": off, "compared": got,
            "quarter_s_nrays": shard, "whole_s_nrays": whole,
            "bound_pct": 100 * whole[0] / (dp * max(s for s, _ in shard))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(quarters(seed, args.device, args.small)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
