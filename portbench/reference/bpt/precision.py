"""The precision of the reference's hits, and the control's switch.

The benchmark's comparison has to fail the reference computed one
precision below the float32 that the renderer states: `lower()` makes
the closest hit return its distance and barycentrics rounded to
bfloat16, the step a kernel that stores its hits in 16 bits would take.
"""
from __future__ import annotations

import contextlib

import torch


class _Precision:
    lowp = False


_STATE = _Precision()


def hit(x: torch.Tensor) -> torch.Tensor:
    """x as the closest hit returns it: float32, or bfloat16 under
    `lower()`."""
    return x.to(torch.bfloat16).to(torch.float32) if _STATE.lowp else x


@contextlib.contextmanager
def lower():
    """Run the reference with its hits in bfloat16 (the control)."""
    _STATE.lowp = True
    try:
        yield
    finally:
        _STATE.lowp = False
