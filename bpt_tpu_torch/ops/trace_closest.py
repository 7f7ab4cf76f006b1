"""K1 and K3: closest hit over the treelet table.

K1 (`closest_hit`, kernel bpt_tpu_torch/csrc/closest_hit.cu) replaces the
TPU kernel bpt_tpu/ops/pallas_trace.py::trace_closest_compact and takes
tables of at most MAX_TREELETS treelets.  K3 (`closest_hit_stream`,
kernel bpt_tpu_torch/csrc/closest_hit_stream.cu) replaces
bpt_tpu/ops/pallas_sweep.py::trace_closest_stream: the same closest hit
with the table taken in chunks of `chunk_nt` treelets, the best hit
carried from chunk to chunk, for tables of any size.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors, or raises.  `<wrapper>.launches`
counts kernel launches; `<plain>.cuda_calls` counts calls of a plain
version with CUDA tensors (a comparison harness, never a route).

One tie rule: chunks in index order (K1 is the one-chunk case); within a
chunk treelets in (entry, index) order while entry < t_best, strict `<`
to improve, lowest slot k on an equal t.  A miss or dead lane gives
(inf, -1, 0, 0).
"""
from __future__ import annotations

import torch

from . import _build
from .intersect import SLAB_ELEMS, check_trace_args, moller_trumbore, slab

# Lanes per triangle-test step of the plain versions (bounds their (n, K)
# temporaries).
_PLAIN_CHUNK = 1 << 16


def _closest_chunks(tg, o, d, min_t, max_t, chunk_nt):
    """The plain closest hit, chunk by chunk; temporaries are at most
    (SLAB_ELEMS / chunk_nt lanes, chunk_nt)."""
    b = o.shape[0]
    nt, _, k = tg.block.shape
    dev = o.device
    t_best = torch.full((b,), torch.inf, dtype=torch.float32, device=dev)
    tri_best = torch.full((b,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    live = torch.nonzero(max_t >= min_t).squeeze(1)
    slots = torch.arange(k, device=dev)
    lanes = max(1, SLAB_ELEMS // chunk_nt)
    for c0 in range(0, nt, chunk_nt):
        c1 = min(c0 + chunk_nt, nt)
        for s0 in range(0, live.numel(), lanes):
            ln = live[s0:s0 + lanes]
            _, entry = slab(tg.bmin[c0:c1], tg.bmax[c0:c1], o[ln], d[ln],
                            min_t[ln], max_t[ln])
            entry_s, order = torch.sort(entry, dim=1, stable=True)
            del entry
            for r in range(c1 - c0):
                # Entries are sorted and t_best only shrinks, so once no
                # lane is active at rank r none is at a later rank.
                act = torch.nonzero(entry_s[:, r] < t_best[ln]).squeeze(1)
                if act.numel() == 0:
                    break
                for s in range(0, act.numel(), _PLAIN_CHUNK):
                    ai = act[s:s + _PLAIN_CHUNK]
                    a = ln[ai]
                    j = order[ai, r] + c0
                    ok, tt, uu, vv = moller_trumbore(tg.block[j], o[a], d[a])
                    tb = t_best[a]
                    t_hi = torch.minimum(tb, max_t[a])
                    ok &= (tt >= min_t[a, None]) & (tt <= t_hi[:, None])
                    t_m = torch.where(ok, tt, torch.full_like(tt, torch.inf))
                    t_new = torch.amin(t_m, dim=1)
                    kk = torch.where(t_m == t_new[:, None], slots,
                                     k).amin(dim=1)
                    improved = t_new < tb
                    a, j, kk = a[improved], j[improved], kk[improved]
                    rows = torch.nonzero(improved).squeeze(1)
                    t_best[a] = t_new[improved]
                    tri_best[a] = tg.tri_index[j, kk]
                    u_best[a] = uu[rows, kk]
                    v_best[a] = vv[rows, kk]
    return t_best, tri_best, u_best, v_best


def closest_hit_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch version of K1: the whole table as one chunk."""
    if o.is_cuda:
        closest_hit_plain.cuda_calls += 1
    return _closest_chunks(tg, o, d, min_t, max_t, max(tg.block.shape[0], 1))


closest_hit_plain.cuda_calls = 0


def closest_hit_stream_plain(tg, o, d, min_t, max_t, chunk_nt):
    """Plain PyTorch version of K3: chunks of `chunk_nt` treelets in index
    order, the best hit carried across them."""
    if o.is_cuda:
        closest_hit_stream_plain.cuda_calls += 1
    return _closest_chunks(tg, o, d, min_t, max_t, chunk_nt)


closest_hit_stream_plain.cuda_calls = 0


def _outputs(b, device):
    return (torch.empty((b,), dtype=torch.float32, device=device),
            torch.empty((b,), dtype=torch.int32, device=device),
            torch.empty((b,), dtype=torch.float32, device=device),
            torch.empty((b,), dtype=torch.float32, device=device))


def closest_hit(tg, o, d, min_t, max_t):
    """K1: closest hit of rays (B, 3) with (B,) windows against a table of
    at most MAX_TREELETS treelets.  Returns (t, tri, u, v), each (B,)."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return closest_hit_plain(tg, o, d, min_t, max_t)
    out = _outputs(b, o.device)
    if b == 0:
        return out
    _build.launch("bpt_closest_hit", o.device, tg.bmin.data_ptr(),
                  tg.bmax.data_ptr(), tg.block.data_ptr(),
                  tg.tri_index.data_ptr(), nt, k, o.data_ptr(), d.data_ptr(),
                  min_t.data_ptr(), max_t.data_ptr(), b,
                  *(x.data_ptr() for x in out))
    closest_hit.launches += 1
    return out


closest_hit.launches = 0


def closest_hit_stream(tg, o, d, min_t, max_t, chunk_nt):
    """K3: closest hit of rays (B, 3) with (B,) windows against a table of
    any size, streamed in chunks of `chunk_nt` (1..MAX_TREELETS)
    treelets.  Returns (t, tri, u, v), each (B,)."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t, chunk_nt)
    if o.device.type == "cpu":
        return closest_hit_stream_plain(tg, o, d, min_t, max_t, chunk_nt)
    out = _outputs(b, o.device)
    if b == 0:
        return out
    _build.launch("bpt_closest_hit_stream", o.device, tg.bmin.data_ptr(),
                  tg.bmax.data_ptr(), tg.block.data_ptr(),
                  tg.tri_index.data_ptr(), nt, k, chunk_nt, o.data_ptr(),
                  d.data_ptr(), min_t.data_ptr(), max_t.data_ptr(), b,
                  *(x.data_ptr() for x in out))
    closest_hit_stream.launches += 1
    return out


closest_hit_stream.launches = 0
