"""Times the first design of the flat trace kernels K1 (closest hit) and
K2 (any hit) against the package's on one card, in turns, on the inputs
of chip_smoke.py's k1/k2 phases: the bench table (19 treelets) and the
subdiv-6 glass box (923 treelets), each with one batch's 262,144 walk
rays, 131,072 primary rays and 8,257,536 connect segments; then the
bench render's profiled batch through both.

    mkdir -p scratch/k12_old
    git archive 58e3622 bpt_tpu_torch/csrc | tar -x -C scratch/k12_old \
        --strip-components=2
    env PYTHONPATH=. python3 probes/k12_old_vs_new.py [--variants ...]

Variants (VARIANTS): `old` is the design of commit 58e3622 (one thread a
ray in a full grid, every slot of the (NT, 9, K) block tested, K1
rescanning the boxes at every visit), read from scratch/k12_old/; `new`
is the package's csrc/.  A variant may also name -D switches of the
package's sources: a design step under test is a build switch while the
work on it goes on.  Each variant is built into its own library under
scratch/k12_build/ with the package's nvcc flags and held bit for bit to
K1's and K2's plain versions.  One JSON line per measurement on standard
output.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
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
from bpt_tpu_torch.ops.trace_any import any_hit_plain
from bpt_tpu_torch.ops.trace_closest import closest_hit_plain

ROOT = Path(__file__).resolve().parent.parent
SCRATCH = ROOT / "scratch"
SRCS = ("closest_hit.cu", "any_hit.cu")
# name -> (source directory, -D flags, C interface: "block" commit
# 58e3622's, "packed" the package's)
VARIANTS = {
    "old": (SCRATCH / "k12_old", [], "block"),
    "new": (_build.CSRC, [], "packed"),
}
SIGNATURES = {
    "block": {"bpt_closest_hit": _build._CLOSEST,
              "bpt_any_hit": _build._ANY},
    "packed": {n: _build._SIGNATURES[n] for n in ("bpt_closest_hit",
                                                  "bpt_any_hit")},
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
        d = SCRATCH / "k12_build" / v
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
        d = SCRATCH / "k12_build" / v
        subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(d / "lib.so"),
                        *(str(d / (s + ".o")) for s in SRCS)], check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for n, sig in SIGNATURES[VARIANTS[v][2]].items():
            getattr(lib, n).argtypes = list(sig)
            getattr(lib, n).restype = ctypes.c_int
        libs[v] = lib
    emit({"probe": "build", "s": time.perf_counter() - t0, "broken": broken,
          "ptxas": {v: {n: r for n, r in cs.ptxas_report(log).items()
                        if "hit_kernel" in n}
                    for v, log in logs.items() if v not in broken}})
    return libs


def _table_args(v, tg, with_index):
    """The table arguments of a variant's C interface."""
    nt, _, k = tg.block.shape
    if VARIANTS[v][2] == "block":
        index = [tg.tri_index.data_ptr()] if with_index else []
        return [tg.bmin.data_ptr(), tg.bmax.data_ptr(), tg.block.data_ptr(),
                *index, nt, k], []
    rows, offsets = packed_triangles(tg)
    counter = torch.zeros(1, dtype=torch.int32, device=tg.block.device)
    return [tg.bmin.data_ptr(), tg.bmax.data_ptr(), rows.data_ptr(),
            offsets.data_ptr(), nt, rows.shape[0]], [counter]


def k1(libs, v, tg, o, d, mn, mx):
    b = o.shape[0]
    out = (torch.empty(b, device=o.device),
           torch.empty(b, dtype=torch.int32, device=o.device),
           torch.empty(b, device=o.device), torch.empty(b, device=o.device))
    table, counter = _table_args(v, tg, True)
    err = libs[v].bpt_closest_hit(
        *table, o.data_ptr(), d.data_ptr(), mn.data_ptr(), mx.data_ptr(), b,
        *(x.data_ptr() for x in out), *(c.data_ptr() for c in counter),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 ({v}) launch failed: CUDA error {err}")
    return out


def k2(libs, v, tg, o, d, mn, mx):
    b = o.shape[0]
    occ = torch.empty(b, dtype=torch.bool, device=o.device)
    table, counter = _table_args(v, tg, False)
    err = libs[v].bpt_any_hit(
        *table, o.data_ptr(), d.data_ptr(), mn.data_ptr(), mx.data_ptr(), b,
        occ.data_ptr(), *(c.data_ptr() for c in counter),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K2 ({v}) launch failed: CUDA error {err}")
    return occ


def table_inputs(scene, cam, dev, n_connect):
    """{input name: (table, args, plain result, bound)} of one scene."""
    rays = cs.compacted_k1_inputs(scene, cam, dev)[0]
    segs = cs.k2_inputs(scene, dev, n_connect)[1]
    out = {}
    for n, a in rays.items():
        ref = closest_hit_plain(scene.treelets, *a)
        out[n] = (scene.treelets, a, ref,
                  cs.trace_bound(scene.treelets, a, "closest", ref))
    ref = any_hit_plain(scene.treelets_any, *segs)
    out["connect"] = (scene.treelets_any, segs, ref,
                      cs.trace_bound(scene.treelets_any, segs, "any", ref))
    return out


def run(libs, v, name, tg, args):
    return (k2 if name == "connect" else k1)(libs, v, tg, *args)


def mismatches(name, got, ref):
    if name == "connect":
        return {"flag_mismatch": int((got != ref).sum())}
    rep = cs.closest_report(got, ref)
    return {"tri_mismatch": rep["tri_mismatch"],
            "t_u_v_bit_mismatch": rep["t_u_v_bit_mismatch"]}


def extras(libs, tname, tg, segs, ref):
    """The package's K2 on the connect batch's live segments alone (what
    the dead lanes cost), and on the table with its treelets reordered
    (the flag does not depend on the order)."""
    from bpt_tpu_torch.accel.treelets import triangle_counts

    o, d, mn, mx = segs
    n_live = int((mx >= mn).sum())
    if bool((mx[:n_live] >= mn[:n_live]).all()):
        live = tuple(x[:n_live].contiguous() for x in segs)
        emit({"probe": "k2_live_only", "table": tname, "lanes": n_live,
              "ms": cs.cuda_ms(lambda: k2(libs, "new", tg, *live)),
              "ms_all_lanes": cs.cuda_ms(lambda: k2(libs, "new", tg, *segs))})
    counts = triangle_counts(tg)
    centre = 0.5 * (tg.bmin + tg.bmax)
    orders = {"fewest_first": torch.argsort(counts, stable=True),
              "most_first": torch.argsort(-counts, stable=True),
              "reversed": torch.arange(counts.shape[0] - 1, -1, -1,
                                       device=counts.device),
              "by_x": torch.argsort(centre[:, 0], stable=True)}
    for name, perm in orders.items():
        tp = type(tg)(*(x[perm].contiguous() for x in tg))
        got = k2(libs, "new", tp, *segs)
        torch.cuda.synchronize()
        emit({"probe": "k2_order", "table": tname, "order": name,
              "flag_mismatch": int((got != ref).sum()),
              "ms": cs.cuda_ms(lambda: k2(libs, "new", tp, *segs)),
              "ms_index_order": cs.cuda_ms(
                  lambda: k2(libs, "new", tg, *segs))})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=["old", "new"])
    ap.add_argument("--define", nargs="*", default=[], metavar="NAME=FLAGS",
                    help="further variants of the package's sources, e.g. "
                         "steps=-DBPT_K1_STEPS=1 (flags joined by commas)")
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--extras", action="store_true",
                    help="K2 on the live segments alone, and on the table "
                         "with its treelets in other orders")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k12_old_vs_new: no CUDA device", file=sys.stderr)
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
    failed = []
    for tname, scene in (("bench", bench), ("subdiv6", cs.phase_subdiv6(dev))):
        inputs = table_inputs(scene, cam, dev, n_connect)
        emit({"probe": "bounds", "table": tname,
              "n_treelets": scene.treelets.block.shape[0],
              "packed_rows": packed_triangles(scene.treelets)[0].shape[0],
              **{n: x[3] for n, x in inputs.items()}})
        for v in names:
            res = {"probe": "variant", "table": tname, "variant": v}
            for n, (tg, a, ref, bound) in inputs.items():
                try:
                    got = run(libs, v, n, tg, a)
                    torch.cuda.synchronize()
                    ms = cs.cuda_ms(lambda: run(libs, v, n, tg, a))
                except Exception as e:  # report, and go on
                    res[n] = {"error": repr(e)}
                    failed.append((tname, v, n))
                    continue
                bad = mismatches(n, got, ref)
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
            turns = {n: {v: [], "new": []} for n in inputs}
            for w in (v, "new", "new", v):
                for n, (tg, a, _, _) in inputs.items():
                    turns[n][w].append(cs.cuda_ms(
                        lambda: run(libs, w, n, tg, a)))
            emit({"probe": "turns", "table": tname, "against": v,
                  "nvidia_smi": cs.nvidia_smi_line(), **turns})
        if args.extras and "new" in names:
            extras(libs, tname, *inputs["connect"][:3])
        del inputs
        torch.cuda.empty_cache()

    # The bench render's profiled batch through `old` and the package's
    # own route, in turns: device time by kernel group.
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk

    if "old" in names and not args.no_render:
        cfg = BDPTConfig(cs.BENCH["width"], cs.BENCH["height"],
                         spp=cs.BENCH["spp"], rr_depth=cs.BENCH["rr_depth"])
        cam_consts = cam.device_constants(dev)
        key = rng.key(cs.SEED, dev)
        sb = cs.BENCH["sb"]
        old_routes = dict(
            closest_hit=lambda t, o, d, mn, mx: k1(libs, "old", t, o, d, mn,
                                                   mx),
            any_hit=lambda t, o, d, mn, mx: k2(libs, "old", t, o, d, mn, mx))
        for v in ("old", "new", "new", "old"):
            ctx = (mock.patch.multiple(api, **old_routes) if v == "old"
                   else contextlib.nullcontext())
            with ctx:
                walls = []
                for _ in range(4):
                    tw = time.perf_counter()
                    render_chunk(bench, cam_consts, cfg, key, sb,
                                 samples_per_batch=sb)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - tw)
                wall = statistics.median(walls[1:])
                prof = cs._profile_batch(bench, cam_consts, cfg, key, wall)
            emit({"probe": "render_batch", "variant": v, "walls": walls,
                  **prof})

    if failed:
        print(f"k12_old_vs_new: failed or disagreed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
