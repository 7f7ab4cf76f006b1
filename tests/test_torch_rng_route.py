"""The routes of core/rng.py on the CPU: CPU keys take the plain versions
and never load the kernel library; the counters `rng.calls.plain` and
`rng.calls.kernel` count only under a profiler; and the kernel wrapper
(ops/threefry.py) hands the kernel a geometry that, read as
csrc/threefry.cu reads it, addresses every lane's key words and data.
The last is checked by an emulation of the kernel's indexing on host
memory, with the plain hash in place of the kernel's, for every shape the
integrators call with; the kernel's own arithmetic is held to the plain
version on the card (tests/test_torch_rng_cuda.py)."""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bpt_tpu_torch import telemetry
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.ops import _build, threefry

MASK = 0xFFFFFFFF
_CTYPES = {np.int64: ctypes.c_int64, np.int32: ctypes.c_int32,
           np.float32: ctypes.c_float}


def _memory(ptr, dtype, count):
    """A writable numpy view of `count` elements at host address `ptr`."""
    return np.ctypeslib.as_array((_CTYPES[dtype] * count).from_address(ptr))


def _emulate(name, device, mode, keys_ptr, data_ptr, kind, tag, n, dims,
             geometry, out_ptr):
    """csrc/threefry.cu's indexing on host memory, the plain hash."""
    assert name == "bpt_threefry" and device.type == "cpu"
    assert 0 <= tag <= MASK and n > 0 and 0 <= dims <= threefry.MAX_DIMS
    g = list(geometry)
    shape, ks, ds, kw = g[:dims], g[dims:2 * dims], g[2 * dims:3 * dims], \
        g[3 * dims]
    coords = np.unravel_index(np.arange(n), shape) if dims else ()
    ko = np.zeros(n, np.int64) + sum(c * s for c, s in zip(coords, ks))
    do = np.zeros(n, np.int64) + sum(c * s for c, s in zip(coords, ds))
    keys = _memory(keys_ptr, np.int64, int(ko.max()) + kw + 1)
    k0 = torch.from_numpy(keys[ko] & MASK)
    k1 = torch.from_numpy(keys[ko + kw] & MASK)
    if mode == threefry.FOLD_IN:
        if kind == 0:
            x = torch.full((n,), tag, dtype=torch.int64)
        else:
            dt = np.int32 if kind == 1 else np.int64
            x = torch.from_numpy(
                _memory(data_ptr, dt, int(do.max()) + 1)[do].astype(np.int64)
                & MASK)
        y0, y1 = rng.threefry2x32(k0, k1, torch.zeros_like(x), x)
        out = _memory(out_ptr, np.int64, 2 * n)
        out[0::2], out[1::2] = y0.numpy(), y1.numpy()
    else:
        draws = 1 if mode == threefry.UNIFORM1 else 2
        out = _memory(out_ptr, np.float32, draws * n)
        for c in range(draws):
            ctr = torch.full((n,), c, dtype=torch.int64)
            y0, y1 = rng.threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
            out[c::draws] = rng._bits_to_unit(y0 ^ y1).numpy()


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(_build, "launch", _emulate)
    return threefry.threefry_cuda


def _keys(b, seed=3):
    return rng.lane_keys(rng.key(seed, "cpu"), torch.arange(b))


def _strided_keys(b):
    """(B, 2) keys whose rows lie 3 elements apart and whose words 1 apart,
    and (B, 2) keys whose two words lie B elements apart."""
    k = _keys(b)
    wide = torch.zeros((b, 3), dtype=torch.int64)
    wide[:, :2] = k
    return wide[:, :2], k.t().contiguous().t()


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


B = 97
_INT32 = np.random.RandomState(1).randint(-2**31, 2**31 - 1, B,
                                          dtype=np.int64)
FOLD_CASES = {
    "lanes_scalar_tag": lambda: (_keys(B), rng.BSDF_SAMPLE),
    "lanes_tag_2e31": lambda: (_keys(B), 2**31 - 1),
    "lanes_tag_4e9": lambda: (_keys(B), 4_000_000_000),
    "lanes_negative_tag": lambda: (_keys(B), -5),
    "lane_keys_int32": lambda: (rng.key(9, "cpu")[None, :],
                                torch.arange(B, dtype=torch.int32)),
    "lane_keys_int64": lambda: (rng.key(9, "cpu")[None, :],
                                torch.arange(B) * 2**29),
    "sample_grid": lambda: (_keys(3)[:, None, :],
                            torch.arange(B, dtype=torch.int32)[None, :]),
    "key_scalar_tag": lambda: (rng.key(7, "cpu"), 5),
    "key_against_ids": lambda: (rng.key(7, "cpu"), torch.arange(B)),
    "per_lane_int32_negative": lambda: (
        _keys(B), torch.from_numpy(_INT32.astype(np.int32))),
    "per_lane_int64_wide": lambda: (
        _keys(B), torch.from_numpy(_INT32 * 2**20 - 2**40)),
    "per_lane_strided_data": lambda: (
        _keys(B), torch.arange(3 * B, dtype=torch.int32)[::3]),
    "rows_apart": lambda: (_strided_keys(B)[0], 11),
    "words_apart": lambda: (_strided_keys(B)[1], torch.arange(B)),
    "zero_dim_data": lambda: (_keys(B), torch.tensor(300)),
    "int16_data": lambda: (_keys(B), torch.arange(B, dtype=torch.int16)),
    "five_dims": lambda: (_keys(6).view(1, 2, 1, 3, 1, 2),
                          torch.arange(4, dtype=torch.int32).view(4, 1, 1,
                                                                  1, 1)),
    "zero_lanes_tag": lambda: (_keys(0), 3),
    "zero_lanes_data": lambda: (_keys(B)[:, None, :],
                                torch.zeros((1, 0), dtype=torch.int32)),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_in_geometry_addresses_every_lane(emulated, case):
    keys, data = FOLD_CASES[case]()
    launches = emulated.launches
    got = threefry.fold_in(keys, data)
    _equal(got, rng.fold_in_plain(keys, data))
    assert emulated.launches == launches + (got.numel() > 0)


UNIFORM_CASES = {
    "lanes": lambda: _keys(B),
    "one_lane": lambda: _keys(1),
    "one_key": lambda: rng.key(7, "cpu"),
    "rows_apart": lambda: _strided_keys(B)[0],
    "words_apart": lambda: _strided_keys(B)[1],
    "grid": lambda: _keys(12).view(3, 4, 2),
    "zero_lanes": lambda: _keys(0),
}


@pytest.mark.parametrize("draws", [1, 2])
@pytest.mark.parametrize("case", sorted(UNIFORM_CASES))
def test_uniform_geometry_addresses_every_lane(emulated, case, draws):
    keys = UNIFORM_CASES[case]()
    kernel, plain = ((threefry.uniform1, rng.uniform1_plain) if draws == 1
                     else (threefry.uniform2, rng.uniform2_plain))
    launches = emulated.launches
    got = kernel(keys)
    _equal(got, plain(keys))
    assert emulated.launches == launches + (got.numel() > 0)


def test_wrapper_refuses_what_the_kernel_does_not_take(emulated):
    with pytest.raises(ValueError):
        threefry.fold_in(_keys(4).to(torch.int32), 1)
    with pytest.raises(ValueError):
        threefry.uniform1(torch.zeros((4, 3), dtype=torch.int64))


def test_cpu_keys_take_the_plain_versions(monkeypatch):
    """No kernel call and no library load for CPU tensors: the library's
    loader and the kernel wrapper raise if reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(threefry, "threefry_cuda", refuse)
    for fn in (threefry.fold_in, threefry.uniform1, threefry.uniform2):
        monkeypatch.setattr(threefry, fn.__name__, refuse)
    k = rng.stream(rng.key(5, "cpu"), rng.POOL_WALK, 3)
    lk = rng.lane_fold(rng.lane_keys(k, torch.arange(B)), rng.RR)
    _equal(lk, rng.fold_in_plain(rng.fold_in_plain(
        k[None, :], torch.arange(B)), rng.RR))
    _equal(rng.uniform1(lk), rng.uniform1_plain(lk))
    _equal(rng.uniform2(lk), rng.uniform2_plain(lk))
    assert rng.fold_in_plain.cuda_calls == 0
    assert rng.uniform1_plain.cuda_calls == 0
    assert rng.uniform2_plain.cuda_calls == 0


def test_plain_calls_count_only_under_a_profiler():
    telemetry.reset()
    k = _keys(8)
    rng.uniform2(rng.lane_fold(k, 3))
    assert telemetry.snapshot() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        rng.uniform1(rng.lane_fold(rng.lane_fold(k, 1), 2))
        rng.uniform2(k)
    snap = telemetry.snapshot()
    telemetry.reset()
    assert snap == {"rng.calls.plain": 4}


def test_kernel_calls_count_only_under_a_profiler(emulated):
    telemetry.reset()
    k = _keys(8)
    threefry.uniform1(threefry.fold_in(k, 3))
    assert telemetry.snapshot() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        threefry.uniform2(threefry.fold_in(k, 1))
        threefry.uniform1(k[:0])
    snap = telemetry.snapshot()
    telemetry.reset()
    assert snap == {"rng.calls.kernel": 3}


@pytest.mark.parametrize("snap, pct", [
    ({"rng.calls.kernel": 54}, 100.0),
    ({"rng.calls.kernel": 1, "rng.calls.plain": 3}, 25.0),
    ({"rng.calls.plain": 7}, 0.0),
    ({"trace.lanes.closest": 5}, None),
    (None, None),
])
def test_kernel_call_share_reader(snap, pct):
    """portbench's rng_kernel_call_pct.bdpt: kernel calls over all RNG
    calls, and nothing where the program counts neither (or has no
    telemetry)."""
    from unittest import mock
    from types import SimpleNamespace

    from portbench.harness import common, spans

    reader = common.load_module("metrics", "rng_kernel_call_pct.bdpt")
    with mock.patch.object(spans, "counters", lambda: snap):
        got = reader.read(SimpleNamespace(trace=None, counts={}))
    assert got == (None if pct is None else pytest.approx(pct))


def test_kernel_call_share_reads_the_port(emulated):
    from types import SimpleNamespace

    from portbench.harness import common

    reader = common.load_module("metrics", "rng_kernel_call_pct.bdpt")
    k = _keys(8)
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        threefry.uniform1(threefry.fold_in(k, 2))
        rng.uniform2(k)
    try:
        got = reader.read(SimpleNamespace(trace=None, counts={}))
    finally:
        telemetry.reset()
    assert got == pytest.approx(100.0 * 2 / 3)
