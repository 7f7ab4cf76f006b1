"""K1: closest hit over the treelet table (replaces the TPU kernel
bpt_tpu/ops/pallas_trace.py::trace_closest_compact).

`closest_hit` is the wrapper: for tensors on the CPU it runs the plain
PyTorch version, for CUDA tensors it launches the kernel in
bpt_tpu_torch/csrc/closest_hit.cu or raises.  `closest_hit.launches`
counts kernel launches; `closest_hit_plain.cuda_calls` counts calls of
the plain version with CUDA tensors (a comparison harness, never a
route).

Both follow one tie rule: treelets in (entry, index) order, strict `<`
to improve, lowest slot k on an equal t.  A miss or dead lane gives
(inf, -1, 0, 0).
"""
from __future__ import annotations

import torch

from . import _build
from .intersect import check_trace_args, moller_trumbore, slab

# Lanes per step of the plain version (bounds its (n, K) temporaries).
_PLAIN_CHUNK = 1 << 16


def closest_hit_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch closest hit: every lane visits its overlapped
    treelets in (entry, index) order while entry < t_best."""
    if o.is_cuda:
        closest_hit_plain.cuda_calls += 1
    b = o.shape[0]
    nt, _, k = tg.block.shape
    dev = o.device
    t_best = torch.full((b,), torch.inf, dtype=torch.float32, device=dev)
    tri_best = torch.full((b,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return t_best, tri_best, u_best, v_best
    _, entry = slab(tg.bmin, tg.bmax, o, d, min_t, max_t)
    entry_s, order = torch.sort(entry, dim=1, stable=True)
    del entry
    slots = torch.arange(k, device=dev)
    for r in range(nt):
        # Entries are sorted and t_best only shrinks, so once no lane is
        # active at rank r none is at a later rank.
        act = torch.nonzero(entry_s[:, r] < t_best).squeeze(1)
        if act.numel() == 0:
            break
        for s in range(0, act.numel(), _PLAIN_CHUNK):
            a = act[s:s + _PLAIN_CHUNK]
            j = order[a, r]
            ok, tt, uu, vv = moller_trumbore(tg.block[j], o[a], d[a])
            tb = t_best[a]
            t_hi = torch.minimum(tb, max_t[a])
            ok &= (tt >= min_t[a, None]) & (tt <= t_hi[:, None])
            t_m = torch.where(ok, tt, torch.full_like(tt, torch.inf))
            t_new = torch.amin(t_m, dim=1)
            kk = torch.where(t_m == t_new[:, None], slots, k).amin(dim=1)
            improved = t_new < tb
            a, j, kk = a[improved], j[improved], kk[improved]
            rows = torch.nonzero(improved).squeeze(1)
            t_best[a] = t_new[improved]
            tri_best[a] = tg.tri_index[j, kk]
            u_best[a] = uu[rows, kk]
            v_best[a] = vv[rows, kk]
    return t_best, tri_best, u_best, v_best


closest_hit_plain.cuda_calls = 0


def closest_hit(tg, o, d, min_t, max_t):
    """Closest hit of rays (B, 3) with (B,) windows against the treelet
    table.  Returns (t, tri, u, v), each (B,)."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return closest_hit_plain(tg, o, d, min_t, max_t)
    t = torch.empty((b,), dtype=torch.float32, device=o.device)
    tri = torch.empty((b,), dtype=torch.int32, device=o.device)
    u = torch.empty((b,), dtype=torch.float32, device=o.device)
    v = torch.empty((b,), dtype=torch.float32, device=o.device)
    if b == 0:
        return t, tri, u, v
    lib = _build.library()
    err = lib.bpt_closest_hit(
        tg.bmin.data_ptr(), tg.bmax.data_ptr(), tg.block.data_ptr(),
        tg.tri_index.data_ptr(), nt, k, o.data_ptr(), d.data_ptr(),
        min_t.data_ptr(), max_t.data_ptr(), b, t.data_ptr(), tri.data_ptr(),
        u.data_ptr(), v.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"closest_hit kernel launch failed: CUDA error "
                           f"{err}")
    closest_hit.launches += 1
    return t, tri, u, v


closest_hit.launches = 0
