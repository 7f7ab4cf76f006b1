"""Closest hit over the treelet table, in plain PyTorch.

A frozen copy of the plain version of K1 in bpt_tpu_torch/ops/
trace_closest.py (`_closest_walk`): each live lane visits the treelets
it overlaps in (entry, index) order over the whole table while entry <
t_best, strict `<` to improve, lowest slot k on an equal t.  A miss or
dead lane gives (inf, -1, 0, 0).
"""
from __future__ import annotations

import torch

from .intersect import SLAB_ELEMS, moller_trumbore, slab

# Lanes per triangle-test step (bounds the (n, K) temporaries).
_PLAIN_CHUNK = 1 << 16


def closest_hit(tg, o, d, min_t, max_t):
    """The plain closest hit: each live lane visits the treelets it
    overlaps in (entry, index) order while entry < t_best.  Temporaries
    are at most (SLAB_ELEMS / NT lanes, NT)."""
    nt = tg.block.shape[0]
    best = _miss(o.shape[0], o.device)
    live = torch.nonzero(max_t >= min_t).squeeze(1)
    lanes = max(1, SLAB_ELEMS // max(nt, 1))
    for s0 in range(0, live.numel(), lanes):
        ln = live[s0:s0 + lanes]
        _, entry = slab(tg.bmin, tg.bmax, o[ln], d[ln], min_t[ln], max_t[ln])
        entry_s, order = torch.sort(entry, dim=1, stable=True)
        del entry
        for r in range(nt):
            # Entries are sorted and t_best only shrinks, so once no lane
            # is active at rank r none is at a later rank.
            act = torch.nonzero(entry_s[:, r] < best[0][ln]).squeeze(1)
            if act.numel() == 0:
                break
            _visit(tg, o, d, min_t, max_t, ln[act], order[act, r], best)
    return best


def _miss(b, device):
    return (torch.full((b,), torch.inf, dtype=torch.float32, device=device),
            torch.full((b,), -1, dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.float32, device=device),
            torch.zeros((b,), dtype=torch.float32, device=device))


def _visit(tg, o, d, min_t, max_t, lanes, rows, best):
    """Test lanes `lanes` against treelets `rows` ((n,) each) and improve
    `best` = (t, tri, u, v) in place: the lowest t of the treelet wins,
    the lowest slot an equal t, and it replaces the best hit only if
    strictly nearer."""
    t_best, tri_best, u_best, v_best = best
    k = tg.block.shape[2]
    slots = torch.arange(k, device=o.device)
    for s in range(0, lanes.numel(), _PLAIN_CHUNK):
        a = lanes[s:s + _PLAIN_CHUNK]
        j = rows[s:s + _PLAIN_CHUNK]
        ok, tt, uu, vv = moller_trumbore(tg.block[j], o[a], d[a])
        tb = t_best[a]
        t_hi = torch.minimum(tb, max_t[a])
        ok &= (tt >= min_t[a, None]) & (tt <= t_hi[:, None])
        t_m = torch.where(ok, tt, torch.full_like(tt, torch.inf))
        t_new = torch.amin(t_m, dim=1)
        kk = torch.where(t_m == t_new[:, None], slots, k).amin(dim=1)
        improved = t_new < tb
        a, j, kk = a[improved], j[improved], kk[improved]
        i = torch.nonzero(improved).squeeze(1)
        t_best[a] = t_new[improved]
        tri_best[a] = tg.tri_index[j, kk]
        u_best[a] = uu[i, kk]
        v_best[a] = vv[i, kk]
