"""Times the first design of the tile kernels K6 (tile-sweep closest hit)
and K7 (tile-union any hit) against the package's on one card, in turns,
on the inputs of chip_smoke.py's k6/k7 phases: the bench table (19
treelets) and the subdiv-6 glass box (923 treelets), K6 on one batch's
262,144 compacted walk rays and 131,072 compacted primary rays, K7 on the
8,257,536 compacted connect segments; and K7 on the segments of one
connect chunk of the pooled render (18 pool vertices x the eye vertices
of the bench configuration with a pool of 64), the most coherent shadow
traffic the renderer has.  The per-lane kernels of the same functions,
K1 and K2, are timed beside them.

    mkdir -p scratch/k67_old
    git archive 7ee9c4a bpt_tpu_torch/csrc | tar -x -C scratch/k67_old \\
        --strip-components=2
    env PYTHONPATH=. python3 probes/k67_old_vs_new.py [--variants ...]

Variants (VARIANTS): `old` is the design of commit 7ee9c4a (one block a
tile, the union by one thread a treelet over the tile's lanes, K6's
order by an O(m^2) rank step, the (NT, 9, K) block with every slot
tested), read from scratch/k67_old/; `new` is the package's csrc/; the
others are the design steps and what was tried and dropped, built from
the two designs kept under probes/k67_variants/ (`staged`: the union's
rows staged in shared memory; `switches`: the package's design with the
switches it was measured with) with -D switches.  Each variant is built
into its own library under scratch/k67_build/ with the package's nvcc
flags and held to the plain versions: K6 bit for bit, K7 flag for flag.
One JSON line per measurement on standard output.  Needs a CUDA card;
exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as cs
from bpt_tpu_torch.accel import api
from bpt_tpu_torch.accel.treelets import packed_triangles
from bpt_tpu_torch.ops import _build
from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_compact_plain
from bpt_tpu_torch.ops.trace_closest import (closest_hit,
                                             closest_hit_sweep_plain)

ROOT = Path(__file__).resolve().parent.parent
SCRATCH = ROOT / "scratch"
KEPT = ROOT / "probes" / "k67_variants"
STAGED, SWITCHES = KEPT / "staged", KEPT / "switches"
SRCS = ("closest_hit_sweep.cu", "any_hit_compact.cu")
# name -> (source directory, -D flags, C interface: "block" commit
# 7ee9c4a's, "packed" the package's)
VARIANTS = {
    "old": (SCRATCH / "k67_old", [], "block"),
    # The steps from `old` to the package's design.  The first three are
    # built from the staged design kept under probes/k67_variants/staged/
    # with its switches off: the tile machinery (persistent blocks, the
    # union by the whole block, K6's sort, packed rows: resident in shared
    # memory on the bench table, read where they are on a larger one)
    # with each thread testing its own ray; + the pooled test where it
    # takes fewer rounds; + K7's run boxes in the walk.  Then, from
    # probes/k67_variants/switches/ (the package's design with its
    # measured switches): no rows in shared memory at all, so more blocks
    # an SM, and K7 slab-testing each listed member again.
    "tile": (STAGED, ["-DBPT_TILE_STAGE=0", "-DBPT_TILE_POOL=0",
                      "-DBPT_K7_RUNS=0"], "packed"),
    "pool": (STAGED, ["-DBPT_TILE_STAGE=0", "-DBPT_K7_RUNS=0"], "packed"),
    "runs": (STAGED, ["-DBPT_TILE_STAGE=0"], "packed"),
    "unpinned": (SWITCHES, ["-DBPT_K7_MASKS=0"], "packed"),
    # The package's: K7's union keeps each warp's ballot of each treelet,
    # which the walk reads in place of a second slab test.
    "new": (_build.CSRC, [], "packed"),
    # Tried and dropped: the rows of each chunk of the union staged in
    # shared memory through two cp.async buffers of 256 (128) rows, on
    # the larger table and on both; always pooled; the rows through the
    # read-only cache; more blocks an SM in the launch bounds; the pooled
    # test's threshold; K7 without the tile union (each warp walks the
    # runs and their members itself, as K2's lanes do).
    "staged": (STAGED, [], "packed"),
    "staged128": (STAGED, ["-DBPT_STAGE_ROWS=128"], "packed"),
    "staged_all": (STAGED, ["-DBPT_TILE_RESIDENT_KB=0"], "packed"),
    "always_pooled": (SWITCHES, ["-DBPT_TILE_POOL=2"], "packed"),
    "ldg": (SWITCHES, ["-DBPT_TILE_LDG=1"], "packed"),
    "blocks6": (SWITCHES, ["-DBPT_TILE_MIN_BLOCKS=6"], "packed"),
    "overhead0": (SWITCHES, ["-DBPT_POOL_OVERHEAD=0"], "packed"),
    "overhead2": (SWITCHES, ["-DBPT_POOL_OVERHEAD=2"], "packed"),
    "nounion": (SWITCHES, ["-DBPT_K7_UNION=0"], "packed"),
}
DEFAULT = list(VARIANTS)
SIGNATURES = {
    "block": {"bpt_closest_hit_sweep": _build._CLOSEST,
              "bpt_any_hit_compact": _build._ANY},
    "packed": {n: _build._SIGNATURES[n] for n in ("bpt_closest_hit_sweep",
                                                  "bpt_any_hit_compact")},
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(names):
    """Build the variants `names` at once; {name: library}.  A variant
    that does not build is reported and left out."""
    nvcc = _build._nvcc()
    t0 = time.perf_counter()
    procs = []
    for v in names:
        src, flags, _ = VARIANTS[v]
        d = SCRATCH / "k67_build" / v
        d.mkdir(parents=True, exist_ok=True)
        for s in SRCS:
            procs.append((v, _build._start(
                [nvcc, *_build.NVCC_FLAGS, *flags, "-c", str(src / s), "-o",
                 str(d / (s + ".o"))])))
    logs = {v: "" for v in names}
    broken = {}
    for v, (cmd, p) in procs:
        out, _ = p.communicate()
        logs[v] += out
        if p.returncode:
            broken[v] = f"{' '.join(cmd)} failed:\n{out}"
    libs = {}
    for v in names:
        if v in broken:
            continue
        d = SCRATCH / "k67_build" / v
        subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(d / "lib.so"),
                        *(str(d / (s + ".o")) for s in SRCS)], check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for n, sig in SIGNATURES[VARIANTS[v][2]].items():
            getattr(lib, n).argtypes = list(sig)
            getattr(lib, n).restype = ctypes.c_int
        libs[v] = lib
    emit({"probe": "build", "s": time.perf_counter() - t0, "broken": broken,
          "ptxas": {v: {n: r for n, r in cs.ptxas_report(log).items()
                        if "sweep_kernel" in n or "compact_kernel" in n}
                    for v, log in logs.items() if v not in broken}})
    return libs


def tile_smem_bytes(tg, masks):
    """Dynamic shared memory of the package's K6 (`masks` False) or K7
    block on `tg` (csrc/intersect.cuh::tile_smem_bytes): boxes, union
    boxes, offsets, the tile's keys (K7: one a treelet and warp) and its
    list."""
    nt = tg.block.shape[0]

    def pad4(n):
        return (n + 3) & ~3

    p2 = 2
    while p2 < nt:
        p2 <<= 1
    keys = nt * 4 if masks else pad4(nt)
    return (pad4(nt * 6) + pad4(-(-nt // 32) * 6) + pad4(nt + 1)
            + keys) * 4 + p2 * 8


def _table_args(v, tg, with_index):
    nt, _, k = tg.block.shape
    if VARIANTS[v][2] == "block":
        index = [tg.tri_index.data_ptr()] if with_index else []
        return [tg.bmin.data_ptr(), tg.bmax.data_ptr(), tg.block.data_ptr(),
                *index, nt, k], []
    rows, offsets = packed_triangles(tg)
    counter = torch.zeros(1, dtype=torch.int32, device=tg.block.device)
    return [tg.bmin.data_ptr(), tg.bmax.data_ptr(), rows.data_ptr(),
            offsets.data_ptr(), nt, rows.shape[0]], [counter]


def k6(libs, v, tg, o, d, mn, mx):
    b = o.shape[0]
    out = (torch.empty(b, device=o.device),
           torch.empty(b, dtype=torch.int32, device=o.device),
           torch.empty(b, device=o.device), torch.empty(b, device=o.device))
    table, counter = _table_args(v, tg, True)
    err = libs[v].bpt_closest_hit_sweep(
        *table, o.data_ptr(), d.data_ptr(), mn.data_ptr(), mx.data_ptr(), b,
        *(x.data_ptr() for x in out), *(c.data_ptr() for c in counter),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K6 ({v}) launch failed: CUDA error {err}")
    return out


def k7(libs, v, tg, o, d, mn, mx):
    b = o.shape[0]
    occ = torch.empty(b, dtype=torch.bool, device=o.device)
    table, counter = _table_args(v, tg, False)
    err = libs[v].bpt_any_hit_compact(
        *table, o.data_ptr(), d.data_ptr(), mn.data_ptr(), mx.data_ptr(), b,
        occ.data_ptr(), *(c.data_ptr() for c in counter),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K7 ({v}) launch failed: CUDA error {err}")
    return occ


def pool_chunk_segments(scene, cam, dev, min_lanes=1_000_000):
    """The compacted segments of the first connect chunk of one pooled
    sample (chip_smoke.py's pool phase configuration), as K2 gets them:
    the first any-hit call of at least `min_lanes` lanes."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.camera import generate_rays
    from bpt_tpu_torch.integrators.bdpt import (BDPTConfig, connect_pool,
                                                eye_subpath_walk,
                                                light_subpath_walk)

    cfg = BDPTConfig(cs.BENCH["width"], cs.BENCH["height"],
                     spp=cs.POOL["spp"], rr_depth=cs.BENCH["rr_depth"],
                     light_pool=cs.POOL["light_pool"])
    cc = cam.device_constants(dev)
    key = rng.key(cs.SEED, dev)
    n = float(cfg.light_pool)
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32, device=dev)
    pids = torch.arange(cfg.light_pool, dtype=torch.int32, device=dev)
    lkeys = rng.lane_keys(key, pix)
    jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    _, d = generate_rays(cc, cfg.width, cfg.height, pix, jitter)
    eye = eye_subpath_walk(scene, cc, cfg, lkeys, d, n_light=n,
                           collect=True)[2]
    pool = light_subpath_walk(
        scene, cc, cfg, rng.lane_keys(rng.stream(key, rng.POOL_WALK), pids),
        cfg.light_pool, torch.ones_like(pids, dtype=torch.bool),
        n_light=n)[0]
    got = []
    real = api.any_hit

    def record(tg, o, d, mn, mx):
        if not got and o.shape[0] >= min_lanes:
            got.append((tg, tuple(x.clone() for x in (o, d, mn, mx))))
        return real(tg, o, d, mn, mx)

    with mock.patch.object(api, "any_hit", record):
        connect_pool(scene, cfg, eye, pool, cfg.light_pool)
    return got[0]


def inputs(scene, cam, dev, n_connect, with_pool):
    """{name: (kernel, table, args, plain result, per-lane kernel's
    result, bound)}."""
    rays = cs.compacted_k1_inputs(scene, cam, dev)[0]
    out = {}
    for n in ("walk", "primary"):
        a = rays[n]
        ref = closest_hit_sweep_plain(scene.treelets, *a)
        out[n] = ("k6", scene.treelets, a, ref,
                  closest_hit(scene.treelets, *a),
                  cs.trace_bound(scene.treelets, a, "closest", ref))
    segs = {"connect": (scene.treelets_any,
                        cs.k2_inputs(scene, dev, n_connect)[1])}
    if with_pool:
        segs["pool_chunk"] = pool_chunk_segments(scene, cam, dev)
    for n, (tg, a) in segs.items():
        ref = any_hit_compact_plain(tg, *a)
        out[n] = ("k7", tg, a, ref, any_hit(tg, *a),
                  cs.trace_bound(tg, a, "any", ref))
    return out


def run(libs, v, kind, tg, args):
    return (k6 if kind == "k6" else k7)(libs, v, tg, *args)


def mismatches(kind, got, ref, lane):
    if kind == "k7":
        return {"flag_mismatch": int((got != ref).sum()),
                "flag_mismatch_vs_k2": int((got != lane).sum())}
    rep = cs.closest_report(got, ref)
    return {"tri_mismatch": rep["tri_mismatch"],
            "t_u_v_bit_mismatch": rep["t_u_v_bit_mismatch"],
            "t_bit_mismatch_vs_k1": cs.bit_mismatch(got[0], lane[0])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=DEFAULT)
    ap.add_argument("--define", nargs="*", default=[], metavar="NAME=FLAGS",
                    help="further variants of the package's sources, e.g. "
                         "s64=-DBPT_STAGE_ROWS=64 (flags joined by commas)")
    ap.add_argument("--tables", nargs="*", default=["bench", "subdiv6"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k67_old_vs_new: no CUDA device", file=sys.stderr)
        return 2
    for spec in args.define:
        name, flags = spec.split("=", 1)
        VARIANTS[name] = (_build.CSRC, flags.split(","), "packed")
        args.variants.append(name)
    names = [v for v in args.variants
             if (VARIANTS[v][0] / SRCS[0]).exists()]
    dev = torch.device("cuda", 0)
    emit({"probe": "device", "nvidia_smi": cs.nvidia_smi_line(),
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "variants": names,
          "flags": {v: VARIANTS[v][1] for v in names},
          "missing": sorted(set(args.variants) - set(names))})
    libs = build(names)
    names = [v for v in names if v in libs]
    _build.library()
    bench, _, cam = cs.bench_scene(dev)
    l = cs.BENCH["rr_depth"] - 1
    n_connect = (l * (l + 2) * cs.BENCH["width"] * cs.BENCH["height"]
                 * cs.BENCH["sb"])
    scenes = {"bench": lambda: bench,
              "subdiv6": lambda: cs.phase_subdiv6(dev)}
    failed = []
    for tname in args.tables:
        scene = scenes[tname]()
        ins = inputs(scene, cam, dev, n_connect, with_pool=tname == "bench")
        emit({"probe": "inputs", "table": tname,
              "n_treelets": scene.treelets.block.shape[0],
              "packed_rows": packed_triangles(scene.treelets)[0].shape[0],
              "new_dynamic_smem_bytes": {
                  "k6": tile_smem_bytes(scene.treelets, False),
                  "k7": tile_smem_bytes(scene.treelets_any, True)},
              **{n: {"kernel": x[0], "lanes": x[2][0].shape[0],
                     "live": int((x[2][3] >= x[2][2]).sum()), **x[5]}
                 for n, x in ins.items()}})
        lane_ms = {}
        for n, (kind, tg, a, _, _, _) in ins.items():
            per_lane = closest_hit if kind == "k6" else any_hit
            lane_ms[n] = cs.cuda_ms(lambda: per_lane(tg, *a))
        emit({"probe": "per_lane_kernels", "table": tname,
              "nvidia_smi": cs.nvidia_smi_line(), "ms": lane_ms})
        for v in names:
            res = {"probe": "variant", "table": tname, "variant": v}
            for n, (kind, tg, a, ref, lane, bound) in ins.items():
                try:
                    got = run(libs, v, kind, tg, a)
                    torch.cuda.synchronize()
                    ms = cs.cuda_ms(lambda: run(libs, v, kind, tg, a))
                except Exception as e:  # report, and go on
                    res[n] = {"error": repr(e)}
                    failed.append((tname, v, n))
                    continue
                bad = mismatches(kind, got, ref, lane)
                res[n] = {"ms": ms, **bad,
                          "share_of_bound": bound["bound_ms"] / ms}
                if any(any(x) if isinstance(x, list) else x
                       for x in bad.values()):
                    failed.append((tname, v, n))
            emit(res)
        # Each variant against the package's design, in turns: variant,
        # new, new, variant.
        for v in names:
            if v == "new" or "new" not in names:
                continue
            turns = {n: {v: [], "new": []} for n in ins}
            for w in (v, "new", "new", v):
                for n, (kind, tg, a, _, _, _) in ins.items():
                    turns[n][w].append(cs.cuda_ms(
                        lambda: run(libs, w, kind, tg, a)))
            emit({"probe": "turns", "table": tname, "against": v,
                  "nvidia_smi": cs.nvidia_smi_line(), **turns})
        del ins
        torch.cuda.empty_cache()
    if failed:
        print(f"k67_old_vs_new: failed or disagreed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
