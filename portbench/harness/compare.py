"""The numbers that decide `correct`, each beside its limit.

A number passes when it is at most its limit (the limits live in
portbench/limits/<cell>.json, with the readings they were set from).  A
number that could not be read (NaN, a missing output) fails.
"""
from __future__ import annotations

import math

import numpy as np


def fb_gap(got, ref) -> float:
    """Widest gap of a framebuffer from the reference's, over the mean
    magnitude of the reference's: max|got - ref| / mean|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.abs(got - ref).max() / max(np.abs(ref).mean(), 1e-30))


def norm_gaps(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms: |‖got[k]‖ - ‖ref[k]‖| over the
    larger of ‖ref[k]‖ and the median leaf's norm, over leaves `keep`
    (default all)."""
    keys = list(ref) if keep is None else list(keep)
    if not keys:
        return 0.0
    gn = {k: float(np.linalg.norm(np.asarray(got[k], np.float64)))
          for k in keys}
    rn = {k: float(np.linalg.norm(np.asarray(ref[k], np.float64)))
          for k in keys}
    med = float(np.median(list(rn.values())))
    worst = 0.0
    for k in keys:
        if not math.isfinite(gn[k]):
            return math.inf
        worst = max(worst, abs(gn[k] - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at most its
    limit, and every limit read."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        v = float(v) if v is not None else math.nan
        out[name] = {"value": v if math.isfinite(v) else str(v),
                     "limit": limit}
        ok &= math.isfinite(v) and v <= limit
    return bool(ok), out
