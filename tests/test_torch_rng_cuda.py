"""The threefry kernel (csrc/threefry.cu, through ops/threefry.py and the
routes of core/rng.py) on the card: bit-identical to the plain versions
(`rng.fold_in_plain`, `uniform1_plain`, `uniform2_plain`) on the same CUDA
tensors, for scalar tags, per-lane int32 and int64 data, every broadcast
the integrators use, key views that are not contiguous and zero lanes; one
launch a call; and a render_chunk of the caustic cell's configuration
equal to the same chunk with the three functions swapped for their plain
versions.  These need an NVIDIA GPU with nvcc and skip without one; run
them on the card with

    python -m pytest tests/test_torch_rng_cuda.py -q -m cuda --noconftest
"""
from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.cuda

# The tags of tests/test_torch_rng.py: 0, 1, BSDF_SAMPLE, EYE_WALK, the
# largest int32 and a tag above it.
TAGS = [0, 1, 5, 300, 2**31 - 1, 4_000_000_000]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rng():
    from bpt_tpu_torch.core import rng

    return rng


def _keys(n, device, seed=7):
    rng = _rng()
    return rng.fold_in_plain(rng.key(seed, device)[None, :],
                             torch.arange(n, device=device))


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.device == want.device
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def _fold(keys, data):
    """The kernel route against the plain version; one launch with lanes."""
    from bpt_tpu_torch.ops import threefry

    rng = _rng()
    launches, plain = threefry.threefry_cuda.launches, \
        rng.fold_in_plain.cuda_calls
    got = rng.fold_in(keys, data)
    assert threefry.threefry_cuda.launches == launches + (got.numel() > 0)
    assert rng.fold_in_plain.cuda_calls == plain
    _equal(got, rng.fold_in_plain(keys, data))


@pytest.mark.parametrize("tag", TAGS)
def test_fold_in_scalar_tags(cuda, tag):
    _fold(_keys(131_072, cuda), tag)
    _fold(_rng().key(123456789, cuda), tag)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_fold_in_per_lane_data(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    info = torch.iinfo(dtype)
    span = 2**31 if dtype == torch.int32 else 2**40
    data = torch.randint(-span, span, (131_072,), generator=gen,
                         device=cuda, dtype=dtype)
    data[:4] = torch.tensor([-1, 0, info.min, info.max], dtype=dtype)
    _fold(_keys(131_072, cuda), data)


def _broadcasts(device):
    rng = _rng()
    k = rng.key(11, device)
    ids = torch.arange(131_072, device=device, dtype=torch.int32)
    return {
        "lanes_tag": (_keys(4096, device), 5),
        "lane_keys": (k[None, :], ids),
        "lane_keys_int64": (k[None, :], ids.long() * 3),
        "sample_grid": (_keys(2, device)[:, None, :], ids[None, :]),
        "key_tag": (k, 400),
        "key_ids": (k, ids),
        "key_zero_dim_data": (_keys(64, device), torch.tensor(9,
                                                              device=device)),
    }


@pytest.mark.parametrize("case", ["lanes_tag", "lane_keys", "lane_keys_int64",
                                  "sample_grid", "key_tag", "key_ids",
                                  "key_zero_dim_data"])
def test_fold_in_broadcasts(cuda, case):
    _fold(*_broadcasts(cuda)[case])


def _views(device):
    k = _keys(65_536, device)
    wide = torch.zeros((65_536, 3), dtype=torch.int64, device=device)
    wide[:, :2] = k
    return {"rows_apart": wide[:, :2], "words_apart": k.t().contiguous().t(),
            "every_third": k[::3], "expanded": k[:1].expand(1000, 2),
            "grid": k.view(256, 256, 2)[:, ::2]}


@pytest.mark.parametrize("view", ["rows_apart", "words_apart", "every_third",
                                  "expanded", "grid"])
def test_non_contiguous_keys(cuda, view):
    from bpt_tpu_torch.ops import threefry

    rng = _rng()
    keys = _views(cuda)[view]
    assert not keys.is_contiguous() or view == "expanded"
    _fold(keys, 17)
    _fold(keys, torch.arange(keys.shape[-2], device=cuda))
    for route, plain in ((rng.uniform1, rng.uniform1_plain),
                         (rng.uniform2, rng.uniform2_plain)):
        launches = threefry.threefry_cuda.launches
        _equal(route(keys), plain(keys))
        assert threefry.threefry_cuda.launches == launches + 1


def test_zero_lanes(cuda):
    from bpt_tpu_torch.ops import threefry

    rng = _rng()
    empty = _keys(0, cuda)
    launches = threefry.threefry_cuda.launches
    _fold(empty, 3)
    _fold(empty, torch.zeros(0, dtype=torch.int32, device=cuda))
    _fold(_keys(8, cuda)[:, None, :],
          torch.zeros((1, 0), dtype=torch.int64, device=cuda))
    _equal(rng.uniform1(empty), rng.uniform1_plain(empty))
    _equal(rng.uniform2(empty), rng.uniform2_plain(empty))
    assert threefry.threefry_cuda.launches == launches


@pytest.mark.parametrize("n", [1, 1_048_576])
def test_uniforms(cuda, n):
    rng = _rng()
    keys = rng.fold_in(_keys(n, cuda, seed=n), rng.BSDF_SAMPLE)
    plain = (rng.uniform1_plain.cuda_calls, rng.uniform2_plain.cuda_calls)
    u1, u2 = rng.uniform1(keys), rng.uniform2(keys)
    assert (rng.uniform1_plain.cuda_calls,
            rng.uniform2_plain.cuda_calls) == plain
    _equal(u1, rng.uniform1_plain(keys))
    _equal(u2, rng.uniform2_plain(keys))
    assert bool((u2 >= 0).all()) and bool((u2 < 1).all())


def test_a_traced_call_is_one_launch(cuda):
    """Under the profiler each call's device work is threefry kernels
    alone, no copy of a tag to the card and no elementwise kernel, and the
    wrapper counts one launch a call.  (The profiler may miss a kernel at
    its start, so four calls are traced and three or four kernels seen.)"""
    from torch.profiler import ProfilerActivity, profile

    from bpt_tpu_torch.ops import threefry

    rng = _rng()
    keys = _keys(131_072, cuda)
    key = rng.key(3, cuda)
    ids = torch.arange(131_072, device=cuda, dtype=torch.int32)
    rng.uniform2(rng.fold_in(keys, 1))
    torch.cuda.synchronize()
    for call in (lambda: rng.fold_in(keys, rng.RR),
                 lambda: rng.lane_keys(key, ids),
                 lambda: rng.stream(key, rng.POOL_WALK),
                 lambda: rng.uniform1(keys), lambda: rng.uniform2(keys)):
        launches = threefry.threefry_cuda.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                call()
            torch.cuda.synchronize()
        assert threefry.threefry_cuda.launches == launches + 4
        work = [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()]
        assert 3 <= len(work) <= 4, work
        assert all("threefry" in name for name in work), work


def test_render_chunk_equals_the_plain_route(cuda, monkeypatch):
    """One render_chunk of the caustic cell's configuration (glass box,
    NO_RR rr_depth 8, 2 samples a batch) at 64x64 and 4 spp: the same ray
    count as with fold_in, uniform1 and uniform2 swapped for their plain
    versions, and a framebuffer within the t=1 splats' index_add_ atomics
    (whose order changes from run to run) of it."""
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk
    from bpt_tpu_torch.ops import threefry
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    rng = _rng()
    scene, _, cam = cornell_box_scene(64, 64, device="cuda",
                                      right_object="glass_sphere",
                                      sphere_subdiv=3)
    cfg = BDPTConfig(64, 64, spp=4, rr_depth=8, no_rr=True)
    cc = cam.device_constants("cuda")
    key = rng.key(2147483901, "cuda")

    def chunk():
        fb, nrays = render_chunk(scene, cc, cfg, key, 4, sample_offset=8,
                                 samples_per_batch=2)
        return fb, int(nrays)

    launches = threefry.threefry_cuda.launches
    fb, nrays = chunk()
    assert threefry.threefry_cuda.launches > launches
    plain = rng.fold_in_plain.cuda_calls
    monkeypatch.setattr(rng, "fold_in", rng.fold_in_plain)
    monkeypatch.setattr(rng, "uniform1", rng.uniform1_plain)
    monkeypatch.setattr(rng, "uniform2", rng.uniform2_plain)
    launches = threefry.threefry_cuda.launches
    fb_p, nrays_p = chunk()
    assert threefry.threefry_cuda.launches == launches
    assert rng.fold_in_plain.cuda_calls > plain
    assert nrays == nrays_p
    # Sums of non-negative splats in another order: within 1e-5 of each
    # pixel (about 80 float32 ulps); portbench's sound runs read 6.96e-6
    # of the mean pixel at most (PERF.md section 2).
    assert torch.allclose(fb, fb_p, rtol=1e-5, atol=1e-6 * float(
        fb_p.abs().mean()))
    assert float(fb_p.abs().mean()) > 0
