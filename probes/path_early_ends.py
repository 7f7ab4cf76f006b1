"""Times one sample of the explicit path tracer (the bench scene,
256x256, the scene file's defaults, one sample a batch, through K1) with
and without the early ends of its loops:

  both         the re-roll and the bounce loops end once no lane is left
               in them (integrators/path.py as it is);
  bounce_only  only the bounce loop ends early: every bounce runs all
               MAX_REROLLS re-roll traces;
  none         both loops run to the end (289 K1 launches a sample).

Each variant renders the same sample (seed and sample index fixed), in
the order both, bounce_only, none, then the reverse, REPS times each
way; the images and ray counts must be bit-equal across variants.  With
`--large`, the same on the large scene (the glass box at subdiv 7,
read back from its scene file, through K3).  One JSON line per
measurement on standard output.  Needs a CUDA card; exits 2 without
one.

    env PYTHONPATH=. python3 probes/path_early_ends.py [--large]
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time
from unittest import mock

import torch

import chip_smoke as cs
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.integrators import path as tp

VARIANTS = ("both", "bounce_only", "none")
REPS = 2
WIDTH = 256


def counted(render):
    """render() -> (image, nrays), timed to the card's end, with the
    closest-hit launches (K1, K3) it made: (image, nrays, wall_s,
    launches)."""
    from bpt_tpu_torch.ops import trace_closest as tc

    kernels = {"k1_closest_hit": tc.closest_hit,
               "k3_closest_hit_stream": tc.closest_hit_stream}
    before = {k: fn.launches for k, fn in kernels.items()}
    torch.cuda.synchronize()
    tw = time.perf_counter()
    img, nr = render()
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    return (img, int(nr), wall,
            {k: fn.launches - before[k] for k, fn in kernels.items()})


def _always(mask):
    return True


@contextlib.contextmanager
def early_ends(variant):
    """integrators/path.py with the loops' early ends of `variant`."""
    if variant == "both":
        yield
    elif variant == "none":
        with mock.patch.object(tp, "_any_live", _always):
            yield
    else:
        reroll = tp._reroll

        def full_reroll(*args):
            with mock.patch.object(tp, "_any_live", _always):
                return reroll(*args)

        with mock.patch.object(tp, "_reroll", full_reroll):
            yield


def measure(name, scene, cam, device, smi):
    cfg = tp.PathConfig(WIDTH, WIDTH, 1)
    cam_consts = cam.device_constants(device)
    key = rng.key(cs.SEED, device)
    ref = None
    walls = {v: [] for v in VARIANTS}
    for variant in VARIANTS:  # warm-up, and the images to compare
        with early_ends(variant):
            img, nrays, _, launches = counted(
                lambda: tp.render_chunk_path(scene, cam_consts, cfg, key, 1))
        if ref is None:
            ref = (img, nrays)
        elif not (torch.equal(img, ref[0]) and nrays == ref[1]):
            raise AssertionError(f"{name}: {variant} changed the render")
        cs.emit({"probe": "path_early_ends", "scene": name,
                 "variant": variant, "nrays": nrays, "launches": launches})
    order = (VARIANTS + VARIANTS[::-1]) * REPS
    for variant in order:
        with early_ends(variant):
            walls[variant].append(counted(
                lambda: tp.render_chunk_path(scene, cam_consts, cfg, key,
                                             1))[2])
    out = {"probe": "path_early_ends", "scene": name, "nvidia_smi": smi,
           "config": f"{cfg.width}x{cfg.height} 1 sample, path defaults, "
                     f"seed{cs.SEED}", "order": list(order),
           "sample_wall_s": walls,
           "median_s": {v: statistics.median(w) for v, w in walls.items()}}
    cs.emit(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--large", action="store_true",
                    help="also the large scene, through K3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_early_ends: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    scene, _, cam = cs.bench_scene(device)
    measure("bench", scene, cam, device, smi)
    if args.large:
        large, _, cfg_t = cs.phase_large_scene(device)
        measure("large", large, cfg_t.camera, device, smi)
    cs.emit({"probe": "path_early_ends", "done": True}, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
