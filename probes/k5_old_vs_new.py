"""Times the first design of K5 (full-table closest hit) against each
step of its redesign and against the package's design on one card, in
turns, with K1 (the per-lane kernel of the same function) timed beside
each, on the inputs of chip_smoke.py's k5 phase: one batch's 262,144
compacted walk rays and 131,072 compacted primary rays on the bench table
(19 treelets) and on the subdiv-6 glass box (923 treelets).

    mkdir -p scratch/k5_old
    git archive 5ba68e2 bpt_tpu_torch/csrc | tar -x -C scratch/k5_old \\
        --strip-components=2
    env PYTHONPATH=. python3 probes/k5_old_vs_new.py [--variants ...]

Variants (VARIANTS): `old` is the design of commit 5ba68e2 (one thread a
ray in a full grid, the boxes reloaded by every block, a 16-key candidate
buffer refilled by a pass over every box, the (NT, 9, K) block with every
slot tested), read from scratch/k5_old/; `new` is the package's csrc/;
the others are built from probes/k5_variants/switches/ (the package's
design with the switches it was measured with) with -D flags: `step_a`
is K1's design on every lane (persistent blocks, the run boxes, the
packed rows), the design steps after it and what was tried and dropped.
Each variant is built into its own library under scratch/k5_build/ with
the package's nvcc flags and held bit for bit to the plain version and to
K1.  One JSON line per measurement on standard output: ms a launch (CUDA
events, 5 launches after a first), the share of the bound
(chip_smoke.py::trace_bound), the share of live lanes whose list
overflowed (from the kernel's own count) and each library's ptxas
report.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from bpt_tpu_torch.accel.treelets import packed_triangles
from bpt_tpu_torch.ops import _build
from bpt_tpu_torch.ops.trace_closest import (closest_hit,
                                             closest_hit_full_plain)

ROOT = Path(__file__).resolve().parent.parent
SCRATCH = ROOT / "scratch"
SWITCHES = ROOT / "probes" / "k5_variants" / "switches"
SRC = "closest_hit_full.cu"
# name -> (source directory, -D flags, C interface: "block" commit
# 5ba68e2's, "packed" the package's)
VARIANTS = {
    "old": (SCRATCH / "k5_old", [], "block"),
    # Step A: K1's PR-5 design through K5's entry, from the shared code.
    "step_a": (SWITCHES, ["-DBPT_K5_LISTS=0"], "packed"),
    # Step B as first written: the warp's entry lists, 16 keys a lane, 256
    # threads a block, three blocks an SM planned (80 registers, a 12-byte
    # spill where the rows are not resident), the rows resident where they
    # fit beside the lists, every run's (lane, member) pairs spread over
    # the warp.
    "spread": (SWITCHES, ["-DBPT_K5_OWN=33", "-DBPT_K5_MIN_BLOCKS=3"],
               "packed"),
    # + a run that 24 or more of the warp's lanes enter scanned by each
    # thread for its own ray.
    "own_scan": (SWITCHES, ["-DBPT_K5_MIN_BLOCKS=3"], "packed"),
    # + two blocks an SM planned, no spill: the package's.
    "new": (_build.CSRC, [], "packed"),
    # Tried: own scans from 16 lanes, and always (no spread pairs); no
    # sort (each visit takes the least key after the last); 8 and 32 keys
    # a lane; 128 threads a block (four blocks an SM planned) and 384 (two
    # planned); the rows never in shared memory, with two and with three
    # blocks an SM planned.
    "own16": (SWITCHES, ["-DBPT_K5_OWN=16"], "packed"),
    "own_all": (SWITCHES, ["-DBPT_K5_OWN=0"], "packed"),
    "select": (SWITCHES, ["-DBPT_K5_SORT=0"], "packed"),
    "keys8": (SWITCHES, ["-DBPT_K5_KEYS=8"], "packed"),
    "keys32": (SWITCHES, ["-DBPT_K5_KEYS=32"], "packed"),
    "threads128": (SWITCHES, ["-DBPT_K5_THREADS=128",
                              "-DBPT_K5_MIN_BLOCKS=4"], "packed"),
    "threads384": (SWITCHES, ["-DBPT_K5_THREADS=384"], "packed"),
    "global_rows": (SWITCHES, ["-DBPT_K5_RESIDENT=0"], "packed"),
    "global_rows3": (SWITCHES, ["-DBPT_K5_RESIDENT=0",
                                "-DBPT_K5_MIN_BLOCKS=3"], "packed"),
}
DEFAULT = list(VARIANTS)
SIGNATURES = {"block": _build._CLOSEST, "packed": _build._CLOSEST_PACKED}


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
        d = SCRATCH / "k5_build" / v
        d.mkdir(parents=True, exist_ok=True)
        procs.append((v, _build._start(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
             "-shared", str(src / SRC), "-o", str(d / "lib.so")])))
    logs, broken, libs = {}, {}, {}
    for v, (cmd, p) in procs:
        logs[v], _ = p.communicate()
        if p.returncode:
            broken[v] = f"{' '.join(cmd)} failed:\n{logs[v]}"
            continue
        lib = ctypes.CDLL(str(SCRATCH / "k5_build" / v / "lib.so"))
        fn = lib.bpt_closest_hit_full
        fn.argtypes = list(SIGNATURES[VARIANTS[v][2]])
        fn.restype = ctypes.c_int
        libs[v] = fn
    emit({"probe": "build", "s": time.perf_counter() - t0, "broken": broken,
          "ptxas": {v: {n: r for n, r in cs.ptxas_report(log).items()
                        if "closest_hit_full_kernel" in n}
                    for v, log in logs.items() if v not in broken}})
    return libs


def k5(libs, v, tg, o, d, mn, mx):
    """Variant v of K5 on (o, d, mn, mx): ((t, tri, u, v), the lanes whose
    list overflowed, as a (1,) tensor, or None for `old`)."""
    b = o.shape[0]
    nt, _, k = tg.block.shape
    out = (torch.empty(b, device=o.device),
           torch.empty(b, dtype=torch.int32, device=o.device),
           torch.empty(b, device=o.device), torch.empty(b, device=o.device))
    rays = [o.data_ptr(), d.data_ptr(), mn.data_ptr(), mx.data_ptr(), b,
            *(x.data_ptr() for x in out)]
    stream = torch.cuda.current_stream().cuda_stream
    if VARIANTS[v][2] == "block":
        err = libs[v](tg.bmin.data_ptr(), tg.bmax.data_ptr(),
                      tg.block.data_ptr(), tg.tri_index.data_ptr(), nt, k,
                      *rays, stream)
        overflow = None
    else:
        rows, offsets = packed_triangles(tg)
        counter = torch.zeros(2, dtype=torch.int32, device=o.device)
        err = libs[v](tg.bmin.data_ptr(), tg.bmax.data_ptr(),
                      rows.data_ptr(), offsets.data_ptr(), nt, rows.shape[0],
                      *rays, counter.data_ptr(), stream)
        overflow = counter[1:]
    if err:
        raise RuntimeError(f"K5 ({v}) launch failed: CUDA error {err}")
    return out, overflow


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=DEFAULT)
    ap.add_argument("--define", nargs="*", default=[], metavar="NAME=FLAGS",
                    help="further variants of the switches source, e.g. "
                         "k12=-DBPT_K5_KEYS=12 (flags joined by commas)")
    ap.add_argument("--tables", nargs="*", default=["bench", "subdiv6"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_old_vs_new: no CUDA device", file=sys.stderr)
        return 2
    for spec in args.define:
        name, flags = spec.split("=", 1)
        VARIANTS[name] = (SWITCHES, flags.split(","), "packed")
        args.variants.append(name)
    names = [v for v in args.variants if (VARIANTS[v][0] / SRC).exists()]
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
    scenes = {"bench": lambda: bench,
              "subdiv6": lambda: cs.phase_subdiv6(dev)}
    failed = []
    for tname in args.tables:
        scene = scenes[tname]()
        tg = scene.treelets
        rays = cs.compacted_k1_inputs(scene, cam, dev)[0]
        ins = {}
        for n in ("walk", "primary"):
            a = rays[n]
            ref = closest_hit_full_plain(tg, *a)
            ins[n] = (a, ref, closest_hit(tg, *a),
                      cs.trace_bound(tg, a, "closest", ref))
        emit({"probe": "inputs", "table": tname,
              "n_treelets": tg.block.shape[0],
              "packed_rows": packed_triangles(tg)[0].shape[0],
              **{n: {"lanes": x[0][0].shape[0],
                     "live": int((x[0][3] >= x[0][2]).sum()),
                     **{k: v for k, v in x[3].items()}}
                 for n, x in ins.items()}})
        emit({"probe": "k1", "table": tname,
              "nvidia_smi": cs.nvidia_smi_line(),
              "ms": {n: cs.cuda_ms(lambda: closest_hit(tg, *x[0]))
                     for n, x in ins.items()}})
        for v in names:
            res = {"probe": "variant", "table": tname, "variant": v}
            for n, (a, ref, lane, bound) in ins.items():
                try:
                    got, overflow = k5(libs, v, tg, *a)
                    torch.cuda.synchronize()
                    ms = cs.cuda_ms(lambda: k5(libs, v, tg, *a))
                except Exception as e:  # report, and go on
                    res[n] = {"error": repr(e)}
                    failed.append((tname, v, n))
                    continue
                rep = cs.closest_report(got, ref)
                bad = {"tri_mismatch": rep["tri_mismatch"],
                       "t_u_v_bit_mismatch": rep["t_u_v_bit_mismatch"],
                       "tri_mismatch_vs_k1": int((got[1] != lane[1]).sum()),
                       "t_u_v_bit_mismatch_vs_k1": [
                           cs.bit_mismatch(got[i], lane[i])
                           for i in (0, 2, 3)]}
                live = int((a[3] >= a[2]).sum())
                res[n] = {"ms": ms, **bad,
                          "share_of_bound": bound["bound_ms"] / ms,
                          "overflow_share": (None if overflow is None else
                                             int(overflow) / max(live, 1))}
                if any(any(x) if isinstance(x, list) else x
                       for x in bad.values()):
                    failed.append((tname, v, n))
            emit(res)
        # Each variant against the package's design and K1, in turns:
        # variant, K1, new, new, K1, variant.
        for v in names:
            if v == "new" or "new" not in names:
                continue
            turns = {n: {v: [], "k1": [], "new": []} for n in ins}
            for w in (v, "k1", "new", "new", "k1", v):
                for n, (a, _, _, _) in ins.items():
                    run = ((lambda: closest_hit(tg, *a)) if w == "k1" else
                           (lambda: k5(libs, w, tg, *a)))
                    turns[n][w].append(cs.cuda_ms(run))
            emit({"probe": "turns", "table": tname, "against": v,
                  "nvidia_smi": cs.nvidia_smi_line(), **turns})
        del ins, rays, scene, tg
        torch.cuda.empty_cache()
    if failed:
        print(f"k5_old_vs_new: failed or disagreed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
