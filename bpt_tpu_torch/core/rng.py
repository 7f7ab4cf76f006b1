"""Counter-based RNG keys: threefry2x32, bit-exact with `jax.random`.

Port of bpt_tpu/core/rng.py.  Every random number is keyed by lane
identity (pixel, sample, depth, purpose) through fold-ins, so a render is
a function of the seed alone, never of batch layout or device.  A key is
an int64 tensor of shape (..., 2) holding two uint32 words; the key
tensor is the generator, and there is no global RNG state.

The arithmetic follows JAX 0.9's `threefry2x32` implementation with
`jax_threefry_partitionable=True` (jax/_src/prng.py):

  * key(seed)        = (seed >> 32, seed & 0xFFFFFFFF);
  * fold_in(k, x)    = threefry2x32(k, (0, uint32(x)));
  * uniform(k, ())   = bits -> float with bits = y0 ^ y1 of
                       threefry2x32(k, (0, 0)); element i of a (2,)
                       draw hashes the counter (0, i);
  * bits -> float    = bitcast((bits >> 9) | 0x3F800000) - 1.

`fold_in`, `uniform1` and `uniform2` route by the keys' device: CUDA keys
take the kernel of bpt_tpu_torch/csrc/threefry.cu (`ops/threefry.py`), one
launch a call; CPU keys take the plain versions `fold_in_plain`,
`uniform1_plain` and `uniform2_plain`, which the CPU tests hold to
`jax.random` bit for bit and the card's tests hold the kernel to.  They
run uint32 arithmetic in int64 with a 32-bit mask after every add and
shift, because PyTorch's uint32 support for shifts and adds is partial:
about 170 tensor operations a call.  A plain version counts its calls on
CUDA tensors in `.cuda_calls` (a comparison harness, never a route); the
counters `rng.calls.plain` and `rng.calls.kernel` add one a call of either
route while a profiler runs.
"""
from __future__ import annotations

import torch

from .. import telemetry
from ..ops import threefry
from ..telemetry import spanned

# Stable purpose tags (same values as the reference package).
EMITTER_SELECT = 1
EMITTER_POSITION = 2
EMITTER_FACE = 3
EMITTER_DIRECTION = 4
BSDF_SAMPLE = 5
RR = 6
PIXEL_JITTER = 7
NEE_SELECT = 8
NEE_POSITION = 9
NEE_FACE = 10
LIGHT_WALK = 100
NEE_WALK = 200
EYE_WALK = 300
POOL_WALK = 400

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32
    words; all four arguments broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, device="cuda"):
    """The raw key of `jax.random.key(seed)` as a (2,) int64 tensor, on
    the card unless `device` says otherwise (CPU code passes "cpu")."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _count_plain(fn, keys):
    telemetry.add("rng.calls.plain", 1)
    if keys.is_cuda:
        fn.cuda_calls += 1


def fold_in_plain(keys, data):
    """The plain version of `fold_in`."""
    _count_plain(fold_in_plain, keys)
    if not torch.is_tensor(data):
        data = torch.full((), int(data) & _MASK, dtype=torch.int64,
                          device=keys.device)
    data = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


@spanned("rng")
def fold_in(keys, data):
    """`jax.random.fold_in` over a (..., 2) key tensor; `data` is an int or
    an integer tensor broadcastable against keys[..., 0]."""
    if keys.is_cuda:
        return threefry.fold_in(keys, data)
    return fold_in_plain(keys, data)


def stream(k, *ids):
    """A sub-key of a (2,) key: each integer tag folded in in turn."""
    for i in ids:
        k = fold_in(k, i)
    return k


def lane_keys(k, lane_ids):
    """(B, 2) keys: one per lane identity (e.g. pixel index)."""
    return fold_in(k[None, :], lane_ids)


def lane_fold(keys, tag):
    """Fold a scalar tag into a (B, 2) key tensor."""
    return fold_in(keys, tag)


def _bits_to_unit(bits):
    """uint32 bits -> U[0, 1) float32, JAX's mantissa construction."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def uniform1_plain(keys):
    """The plain version of `uniform1`."""
    _count_plain(uniform1_plain, keys)
    zero = torch.zeros_like(keys[..., 0])
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], zero, zero)
    return _bits_to_unit(y1 ^ y2)


def uniform2_plain(keys):
    """The plain version of `uniform2`."""
    _count_plain(uniform2_plain, keys)
    k1 = keys[..., 0:1]
    k2 = keys[..., 1:2]
    ctr = torch.arange(2, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    return _bits_to_unit(y1 ^ y2)


fold_in_plain.cuda_calls = 0
uniform1_plain.cuda_calls = 0
uniform2_plain.cuda_calls = 0


@spanned("rng")
def uniform1(keys):
    """One U[0,1) float per lane key -> (B,)."""
    if keys.is_cuda:
        return threefry.uniform1(keys)
    return uniform1_plain(keys)


@spanned("rng")
def uniform2(keys):
    """U[0,1)^2 per lane key -> (B, 2)."""
    if keys.is_cuda:
        return threefry.uniform2(keys)
    return uniform2_plain(keys)
