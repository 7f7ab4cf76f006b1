"""Times earlier designs of the streamed kernels K3 (closest hit) and K4
(any hit) against the package's on one card, in turns, on the inputs of
chip_smoke.py's k3/k4 phases (the 3,656-treelet large scene: 262,144
walk and 131,072 primary rays, 8,257,536 connect segments), and then the
large render's profiled batch through the chunked kernels of commit
be61a0e and the package's.

    mkdir -p scratch/k34_old
    git archive be61a0e bpt_tpu_torch/csrc | tar -x -C scratch/k34_old \
        --strip-components=2
    env PYTHONPATH=. python3 probes/k34_old_vs_new.py [--variants ...]

Variants (VARIANTS): `old` is the design of commit be61a0e (chunks of
256 boxes in shared memory), read from scratch/k34_old/; `soa` (group
boxes, candidate list, resident boxes, persistent threads), `rows` (+
triangle rows) and `counts` (+ triangle counts) are the steps from it
to the package's design, kept under probes/k34_variants/, with `soa_*`
and `rows_steps` the same sources built with one of their -D switches;
`new` is the package's csrc/.  Each is built into its own library under
scratch/k34_build/ with the package's nvcc flags, and held bit for bit
to K1's and K2's plain versions (`old` on t and flags only: its chunk
order may pick another triangle on an exact-t tie).  One JSON line per
measurement on standard output.  Needs a CUDA card; exits 2 without
one.
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
from bpt_tpu_torch.accel.treelets import (group_boxes, triangle_counts,
                                          triangle_rows)
from bpt_tpu_torch.ops import _build
from bpt_tpu_torch.ops.trace_any import any_hit_plain
from bpt_tpu_torch.ops.trace_closest import closest_hit_plain

ROOT = Path(__file__).resolve().parent.parent
SCRATCH = ROOT / "scratch"
KEPT = ROOT / "probes" / "k34_variants"
SRCS = ("closest_hit_stream.cu", "any_hit_stream.cu")
# name -> (source directory, -D flags, triangle layout the kernels read,
# C interface: "chunks" be61a0e's, "groups" with group boxes, "counts" with
# group boxes and triangle counts)
VARIANTS = {
    "old": (SCRATCH / "k34_old", [], "block", "chunks"),
    "soa": (KEPT / "soa", [], "block", "groups"),
    "soa_fetch0": (KEPT / "soa", ["-DBPT_STREAM_FETCH=0"], "block",
                   "groups"),
    "soa_fetch1": (KEPT / "soa", ["-DBPT_STREAM_FETCH=1"], "block",
                   "groups"),
    "soa_global": (KEPT / "soa", ["-DBPT_STREAM_RESIDENT_BYTES=0"], "block",
                   "groups"),
    "rows": (KEPT / "rows", [], "rows", "groups"),
    "rows_steps": (KEPT / "rows", ["-DBPT_ANY_STEPS=1",
                                   "-DBPT_CLOSEST_STEPS=1"], "rows",
                   "groups"),
    "counts": (KEPT / "counts", [], "rows", "counts"),
    "new": (_build.CSRC, [], "rows", "counts"),
}
OLD_CHUNK = 256
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "chunks": {"bpt_closest_hit_stream": (P, P, P, P, I, I, I, P, P, P, P, I,
                                          P, P, P, P, P),
               "bpt_any_hit_stream": (P, P, P, I, I, I, P, P, P, P, I, P, P)},
    "groups": {"bpt_closest_hit_stream": (P, P, P, P, P, P, I, I, I, I, P, P,
                                          P, P, I, P, P, P, P, P, P),
               "bpt_any_hit_stream": (P, P, P, P, P, I, I, I, I, P, P, P, P,
                                      I, P, P, P)},
    "counts": {n: _build._SIGNATURES[n] for n in ("bpt_closest_hit_stream",
                                                  "bpt_any_hit_stream")},
}
def emit(obj):
    print(json.dumps(obj), flush=True)


def build(names):
    """Build the variants `names` at once; {name: library}."""
    nvcc = _build._nvcc()
    t0 = time.perf_counter()
    procs = []
    for v in names:
        src, flags, _, _ = VARIANTS[v]
        d = SCRATCH / "k34_build" / v
        d.mkdir(parents=True, exist_ok=True)
        for s in SRCS:
            procs.append((v, _build._start(
                [nvcc, *_build.NVCC_FLAGS, *flags, "-c", str(src / s), "-o",
                 str(d / (s + ".o"))])))
    logs = {v: "" for v in names}
    for v, (cmd, p) in procs:
        out, _ = p.communicate()
        logs[v] += out
        if p.returncode:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{out}")
    libs = {}
    for v in names:
        d = SCRATCH / "k34_build" / v
        subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(d / "lib.so"),
                        *(str(d / (s + ".o")) for s in SRCS)], check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for n, sig in SIGNATURES[VARIANTS[v][3]].items():
            getattr(lib, n).argtypes = list(sig)
            getattr(lib, n).restype = ctypes.c_int
        libs[v] = lib
    emit({"probe": "build", "s": time.perf_counter() - t0,
          "ptxas": {v: {n: r for n, r in cs.ptxas_report(log).items()
                        if "stream_kernel" in n} for v, log in logs.items()}})
    return libs


def _tris(v, tg):
    return triangle_rows(tg) if VARIANTS[v][2] == "rows" else tg.block


def _counts(v, tg):
    """The triangle-count argument of a variant's C interface, if any."""
    return ([triangle_counts(tg).data_ptr()] if VARIANTS[v][3] == "counts"
            else [])


def k3(libs, v, tg, o, d, mn, mx, g):
    lib = libs[v]
    b = o.shape[0]
    nt, _, k = tg.block.shape
    out = (torch.empty(b, device=o.device),
           torch.empty(b, dtype=torch.int32, device=o.device),
           torch.empty(b, device=o.device), torch.empty(b, device=o.device))
    s = torch.cuda.current_stream().cuda_stream
    ptr = [x.data_ptr() for x in out]
    if v == "old":
        err = lib.bpt_closest_hit_stream(
            tg.bmin.data_ptr(), tg.bmax.data_ptr(), tg.block.data_ptr(),
            tg.tri_index.data_ptr(), nt, k, g, o.data_ptr(), d.data_ptr(),
            mn.data_ptr(), mx.data_ptr(), b, *ptr, s)
    else:
        gmin, gmax = group_boxes(tg, g)
        counter = torch.zeros(1, dtype=torch.int32, device=o.device)
        err = lib.bpt_closest_hit_stream(
            tg.bmin.data_ptr(), tg.bmax.data_ptr(), gmin.data_ptr(),
            gmax.data_ptr(), _tris(v, tg).data_ptr(), *_counts(v, tg),
            tg.tri_index.data_ptr(), nt, gmin.shape[0], g, k, o.data_ptr(),
            d.data_ptr(), mn.data_ptr(), mx.data_ptr(), b, *ptr,
            counter.data_ptr(), s)
    if err:
        raise RuntimeError(f"K3 ({v}) launch failed: CUDA error {err}")
    return out


def k4(libs, v, tg, o, d, mn, mx, g):
    lib = libs[v]
    b = o.shape[0]
    nt, _, k = tg.block.shape
    occ = torch.empty(b, dtype=torch.bool, device=o.device)
    s = torch.cuda.current_stream().cuda_stream
    if v == "old":
        err = lib.bpt_any_hit_stream(
            tg.bmin.data_ptr(), tg.bmax.data_ptr(), tg.block.data_ptr(), nt, k,
            g, o.data_ptr(), d.data_ptr(), mn.data_ptr(), mx.data_ptr(), b,
            occ.data_ptr(), s)
    else:
        gmin, gmax = group_boxes(tg, g)
        counter = torch.zeros(1, dtype=torch.int32, device=o.device)
        err = lib.bpt_any_hit_stream(
            tg.bmin.data_ptr(), tg.bmax.data_ptr(), gmin.data_ptr(),
            gmax.data_ptr(), _tris(v, tg).data_ptr(), *_counts(v, tg), nt,
            gmin.shape[0], g, k, o.data_ptr(), d.data_ptr(), mn.data_ptr(),
            mx.data_ptr(), b, occ.data_ptr(), counter.data_ptr(), s)
    if err:
        raise RuntimeError(f"K4 ({v}) launch failed: CUDA error {err}")
    return occ


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*",
                    default=["old", "new"])
    ap.add_argument("--groups", nargs="*", type=int,
                    default=[api.STREAM_CHUNK])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k34_old_vs_new: no CUDA device", file=sys.stderr)
        return 2
    names = [v for v in args.variants
             if (VARIANTS[v][0] / SRCS[0]).exists()]
    dev = torch.device("cuda", 0)
    emit({"probe": "device", "nvidia_smi": cs.nvidia_smi_line(),
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "variants": names,
          "missing": sorted(set(args.variants) - set(names))})
    libs = build(names)
    _build.library()
    large, cfg_t = cs.phase_large_scene(dev)
    tg, tga = large.treelets, large.treelets_any
    rays = cs.compacted_k1_inputs(large, cfg_t.camera, dev)[0]
    l = cs.BENCH["rr_depth"] - 1
    n_connect = (l * (l + 2) * cs.BENCH["width"] * cs.BENCH["height"]
                 * cs.BENCH["sb"])
    segs = cs.k2_inputs(large, dev, n_connect)[1]
    ref_c = {n: closest_hit_plain(tg, *a) for n, a in rays.items()}
    ref_a = any_hit_plain(tga, *segs)
    bounds = {n: cs.trace_bound(tg, a, "closest", ref_c[n])
              for n, a in rays.items()}
    bounds["connect"] = cs.trace_bound(tga, segs, "any", ref_a)
    emit({"probe": "bounds", **bounds})

    def check_and_time(v, g):
        res = {"probe": "variant", "variant": v, "g": g}
        for n, a in rays.items():
            got = k3(libs, v, tg, *a, g)
            torch.cuda.synchronize()
            rep = cs.closest_report(got, ref_c[n])
            ms = cs.cuda_ms(lambda: k3(libs, v, tg, *a, g))
            res[n] = {"ms": ms, "tri_mismatch_vs_k1": rep["tri_mismatch"],
                      "t_u_v_bit_mismatch_vs_k1": rep["t_u_v_bit_mismatch"],
                      "share_of_bound": bounds[n]["bound_ms"] / ms}
        got = k4(libs, v, tga, *segs, g)
        torch.cuda.synchronize()
        ms = cs.cuda_ms(lambda: k4(libs, v, tga, *segs, g))
        res["connect"] = {"ms": ms,
                          "flag_mismatch_vs_k2": int((got != ref_a).sum()),
                          "share_of_bound": bounds["connect"]["bound_ms"] / ms}
        emit(res)
        bad = res["connect"]["flag_mismatch_vs_k2"] or any(
            res[n]["t_u_v_bit_mismatch_vs_k1"][0] or (
                v != "old" and (res[n]["tri_mismatch_vs_k1"]
                                or any(res[n]["t_u_v_bit_mismatch_vs_k1"])))
            for n in rays)
        return not bad

    failed = []
    for v in names:
        for g in ([OLD_CHUNK] if v == "old" else args.groups):
            try:
                ok = check_and_time(v, g)
            except Exception as e:  # report, and go on to the next variant
                emit({"probe": "variant", "variant": v, "g": g,
                      "error": repr(e)})
                ok = False
            if not ok:
                failed.append((v, g))

    # Each variant against the package's design at the route's group
    # size, in turns: variant, new, new, variant.
    g_new = api.STREAM_CHUNK
    for v in names:
        if v == "new":
            continue
        g = OLD_CHUNK if v == "old" else g_new
        turns = {n: {v: [], "new": []} for n in (*rays, "connect")}
        for w in (v, "new", "new", v):
            gw = g if w == v else g_new
            for n, a in rays.items():
                turns[n][w].append(cs.cuda_ms(
                    lambda: k3(libs, w, tg, *a, gw)))
            turns["connect"][w].append(
                cs.cuda_ms(lambda: k4(libs, w, tga, *segs, gw)))
        emit({"probe": "turns", "against": v, "g": g, "g_new": g_new,
              "nvidia_smi": cs.nvidia_smi_line(), **turns})

    # The large render's profiled batch through `old` and the package's
    # own route, in turns: device time by kernel group.
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk

    if "old" in names:
        cfg = BDPTConfig(cfg_t.width, cfg_t.height, spp=cfg_t.spp,
                         rr_depth=cfg_t.rr_depth)
        cam_consts = cfg_t.camera.device_constants(dev)
        key = rng.key(cs.SEED, dev)
        sb = cs.BENCH["sb"]
        old_routes = dict(
            closest_hit_stream=lambda t, o, d, mn, mx, c: k3(
                libs, "old", t, o, d, mn, mx, OLD_CHUNK),
            any_hit_stream=lambda t, o, d, mn, mx, c: k4(
                libs, "old", t, o, d, mn, mx, OLD_CHUNK))
        for v in ("old", "new", "new", "old"):
            ctx = (mock.patch.multiple(api, **old_routes) if v == "old"
                   else contextlib.nullcontext())
            with ctx:
                walls = []
                for _ in range(4):
                    tw = time.perf_counter()
                    render_chunk(large, cam_consts, cfg, key, sb,
                                 samples_per_batch=sb)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - tw)
                wall = statistics.median(walls[1:])
                prof = cs._profile_batch(large, cam_consts, cfg, key, wall)
            emit({"probe": "render_batch", "variant": v, "walls": walls,
                  **prof})

    if failed:
        print(f"k34_old_vs_new: variants that failed or disagreed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
