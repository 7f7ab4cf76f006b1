"""The port's threefry2x32 keys and uniforms are bit-exact with jax.random
(bpt_tpu_torch/core/rng.py against bpt_tpu/core/rng.py)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import rng as jrng
from bpt_tpu_torch.core import rng as trng

N_LANES = 10_000
TAGS = [0, 1, jrng.BSDF_SAMPLE, jrng.EYE_WALK, 2**31 - 1,
        4_000_000_000]


def _bits(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _lane_ids(seed=0):
    return np.random.RandomState(seed).randint(
        0, 2**31 - 1, N_LANES).astype(np.int32)


def test_jax_prng_is_the_one_the_port_assumes():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2**31 - 1])
def test_key(seed):
    np.testing.assert_array_equal(
        _bits(jax.random.key(seed)), trng.key(seed, device="cpu").numpy())


@pytest.mark.parametrize("seed", [1, 7])
def test_lane_keys(seed):
    ids = _lane_ids(seed)
    j = jrng.lane_keys(jax.random.key(seed), jnp.asarray(ids))
    t = trng.lane_keys(trng.key(seed, device="cpu"), torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(j), t.numpy())


@pytest.mark.parametrize("tag", TAGS)
def test_lane_fold_and_uniforms(tag):
    ids = _lane_ids(3)
    jk = jrng.lane_fold(jrng.lane_keys(jax.random.key(7), jnp.asarray(ids)),
                        tag)
    tk = trng.lane_fold(trng.lane_keys(trng.key(7, device="cpu"),
                                       torch.from_numpy(ids)),
                        tag)
    np.testing.assert_array_equal(_bits(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jrng.uniform1(jk)),
                                  trng.uniform1(tk).numpy())
    np.testing.assert_array_equal(np.asarray(jrng.uniform2(jk)),
                                  trng.uniform2(tk).numpy())


def test_fold_in_with_traced_tags_per_lane():
    """fold_in of a per-lane tag tensor == vmapped jax.random.fold_in."""
    ids = _lane_ids(5)
    tags = np.random.RandomState(6).randint(0, 2**31 - 1, N_LANES).astype(
        np.int32)
    jk = jrng.lane_keys(jax.random.key(11), jnp.asarray(ids))
    jf = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(tags))
    tk = trng.lane_keys(trng.key(11, device="cpu"), torch.from_numpy(ids))
    tf = trng.fold_in(tk, torch.from_numpy(tags))
    np.testing.assert_array_equal(_bits(jf), tf.numpy())


def test_render_chunk_key_layout():
    """The (sample, pixel) key grid of render_chunk, pixel-major."""
    sb, pix = 2, np.arange(64, dtype=np.int32)
    key = jax.random.key(7)
    sids = 3 + jnp.arange(sb)
    skeys = jax.vmap(lambda s: jax.random.fold_in(key, s))(sids)
    jl = jax.vmap(lambda sk: jrng.lane_keys(sk, jnp.asarray(pix)))(skeys)
    jl = jl.T.reshape((sb * pix.size,))
    tkey = trng.key(7, device="cpu")
    tskeys = trng.fold_in(tkey[None, :], 3 + torch.arange(sb))
    tl = trng.fold_in(tskeys[:, None, :], torch.from_numpy(pix)[None, :])
    tl = tl.transpose(0, 1).reshape(sb * pix.size, 2)
    np.testing.assert_array_equal(_bits(jl), tl.numpy())


def test_uniforms_lie_in_unit_interval():
    u = trng.uniform2(trng.lane_keys(trng.key(0, device="cpu"),
                                     torch.arange(N_LANES)))
    assert u.dtype == torch.float32
    assert bool((u >= 0).all()) and bool((u < 1).all())
