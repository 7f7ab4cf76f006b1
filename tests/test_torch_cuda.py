"""The CUDA kernels K1-K7 against their plain PyTorch versions on the
card: bit-equal hits and equal occlusion flags; K3-K7 also against K1
and K2; K1 and K2 also on the 923-treelet table, on the largest table
they take and on edge batches.  Through the kernels against the same
through the plain versions: renders of BDPT and of every integrator of
path.py, direct.py and misc.py, with K5/K7 or K6 swapped in for K1/K2,
and at two batch sizes; gradients of every estimator (and central
finite differences); each realtime pass; the pooled render and the
device mesh at world size 1 over NCCL; the large scene read from its
scene file, rendered and differentiated through K3/K4.  The
estimators' agreement and the command-line renderer on the card.
These need an NVIDIA GPU with nvcc and skip without one; run them on
the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

import numpy as np
import pytest
import torch

from bpt_tpu_torch.ops.intersect import STREAM_CHUNK

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, _ = cornell_box_scene(32, 32, device="cuda",
                                    right_object="glass_sphere",
                                    sphere_subdiv=3)
    return scene


def _rays(n, seed, device="cuda", segment=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = torch.tensor([-0.95, 0.05, -0.95], device=device)
    hi = torch.tensor([0.95, 1.95, 0.95], device=device)
    o = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=device)
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    live = torch.rand(n, generator=gen, device=device) < 0.6
    far = (torch.rand(n, generator=gen, device=device) * 3.0 if segment
           else torch.full((n,), float("inf"), device=device))
    mx = torch.where(live, far, torch.full_like(far, -1.0))
    return o, d, torch.full((n,), 1e-8, device=device), mx


@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_closest_kernel_bit_equal_to_plain(cuda_scene, n):
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_plain

    args = _rays(n, seed=n)
    launches = closest_hit.launches
    got = closest_hit(cuda_scene.treelets, *args)
    ref = closest_hit_plain(cuda_scene.treelets, *args)
    torch.cuda.synchronize()
    assert closest_hit.launches == launches + 1
    assert torch.equal(got[1], ref[1])
    for g, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_any_kernel_equal_to_plain(cuda_scene, n):
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain

    args = _rays(n, seed=n + 1, segment=True)
    launches = any_hit.launches
    got = any_hit(cuda_scene.treelets_any, *args)
    ref = any_hit_plain(cuda_scene.treelets_any, *args)
    torch.cuda.synchronize()
    assert any_hit.launches == launches + 1
    assert torch.equal(got, ref)


K12 = ("k1_closest_hit", "k2_any_hit")
K34 = ("k3_closest_hit_stream", "k4_any_hit_stream")
G1 = "g1_gather_rows_backward"


@contextmanager
def _launched(*used):
    """The kernel launches of the block, counted by chip_smoke's counters
    (reset on entry): each kernel of `used` launched, no other trace
    kernel or G1, and no plain version of a trace kernel, of G1 or of the
    RNG called on CUDA tensors.  Yields the launches by kernel, filled
    in on exit."""
    import chip_smoke

    launches = {}
    chip_smoke.reset_counts()
    yield launches
    torch.cuda.synchronize()
    got, plain_calls = chip_smoke.read_counts()
    launches.update(got)
    assert plain_calls == 0, "plain versions ran on CUDA tensors"
    assert all(got[k] > 0 for k in used), got
    assert not any(n for k, n in got.items() if k not in used), got


def _k12_plain():
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc

    return {"closest_hit": tc.closest_hit_plain, "any_hit": ta.any_hit_plain}


def _kernel_and_plain(render, used, routes=None):
    """render() -> (img, nrays) through the kernels, held by
    _launched(*used), and through the plain `routes` (K1's and K2's by
    default) swapped into accel/api.py here only:
    (kernel, plain, launches of the kernel render)."""
    from unittest import mock

    from bpt_tpu_torch.accel import api

    with _launched(*used) as launches:
        kernel = render()
    with mock.patch.multiple(api, **(routes or _k12_plain())):
        plain = render()
    return kernel, plain, launches


def _cam32():
    from bpt_tpu_torch.core.camera import Camera

    return Camera.make([0.0, 1.0, 3.8], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0],
                       39.0, 32, 32)


# Routes swapped into accel/api.py for K1 and K2 (the package routes to
# K5-K7 nowhere): {api name: kernel}, the kernels launched, and the
# kernel of the K1/K2 route each stands for.
ROUTES = {
    "k1_k2": ({}, {"k1_closest_hit": "k1_closest_hit",
                   "k2_any_hit": "k2_any_hit"}),
    "k5_k7": ({"closest_hit": "closest_hit_full",
               "any_hit": "any_hit_compact"},
              {"k5_closest_hit_full": "k1_closest_hit",
               "k7_any_hit_compact": "k2_any_hit"}),
    "k6": ({"closest_hit": "closest_hit_sweep"},
           {"k6_closest_hit_sweep": "k1_closest_hit",
            "k2_any_hit": "k2_any_hit"}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_render_matches_plain_render(cuda_scene, route):
    """BDPT at 32x32 through K1/K2, or with K5 and K7, or K6, swapped in
    for them, against the render through K1's and K2's plain versions.
    Each kernel of the route launches as often as the K1/K2 kernel it
    stands for.  K1/K2 and K5/K7 compute the same function: the same
    rays, and every pixel within rtol 1e-4 (the t=1 splats add with
    atomics).  K6 may take another triangle on an exact-t tie, so the
    aggregate gate."""
    from unittest import mock

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc

    swaps, stands_for = ROUTES[route]
    cfg = BDPTConfig(32, 32, spp=2, rr_depth=4)
    cam = _cam32()

    def render():
        return render_image(cuda_scene, cam, cfg, seed=1)

    with _launched(*K12) as base:
        render()
    swaps = {k: getattr(tc if k == "closest_hit" else ta, v)
             for k, v in swaps.items()}
    with mock.patch.multiple(api, **swaps) if swaps else nullcontext():
        kernel, plain, launches = _kernel_and_plain(render, stands_for)
    for k, b in stands_for.items():
        assert launches[k] == base[b], (launches, base)
    if route == "k6":
        _assert_agree(kernel, plain)
    else:
        (a, na), (b, nb) = kernel, plain
        assert na == nb
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _assert_agree(kernel, plain):
    """The aggregate gate of a kernel render against a plain one: nrays
    and mean within 1e-3 relative, at most 2% of pixels off by >0.1%."""
    (a, na), (b, nb) = kernel, plain
    a, b = a.double(), b.double()
    assert torch.isfinite(a).all() and float(a.mean()) > 0.0
    assert abs(na - nb) <= 1e-3 * nb
    assert abs(float(a.mean() - b.mean())) <= 1e-3 * float(b.mean())
    off = (a - b).abs() / torch.clamp_min(b.abs(), 1e-3) > 1e-3
    assert float(off.double().mean()) <= 0.02


@pytest.mark.parametrize("change", [
    dict(no_rr=False, rr_depth=2, max_bounces=6), dict(mode="light_trace"),
    dict(mode="path_trace")], ids=["rr", "light_trace", "path_trace"])
def test_estimator_renders_through_the_kernels(cuda_scene, change):
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image

    cfg = BDPTConfig(32, 32, **{"spp": 2, "rr_depth": 4, **change})
    cam = _cam32()
    kernel, plain, _ = _kernel_and_plain(
        lambda: render_image(cuda_scene, cam, cfg, seed=1), K12)
    _assert_agree(kernel, plain)


@pytest.mark.parametrize("sb,budget", [(1, 4_000), (4, 20_000)],
                         ids=["sb1", "sb4"])
def test_chunked_connect_through_the_kernels(cuda_scene, monkeypatch, sb,
                                             budget):
    """render_chunk (4 spp, rr_depth 4) with the pair connect in chunks,
    through K1/K2 against their plain versions, at two batch sizes: 1
    sample a batch, whose 3 x 3 x 1,024-lane pair grid exceeds a budget
    of 4,000, and 4, whose 3 x 3 x 4,096 lanes exceed 20,000.  A batch
    launches K1 for the primaries and 3 walk depths, and K2 for one NEE
    + t=1 trace and three one-row pair traces.  At 4 a batch the render
    is also held to the same samples at 2 a batch (unchunked: one K2
    launch a batch) by the aggregate gate."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators import bdpt

    monkeypatch.setattr(bdpt, "MEGA_MAX_LANES", budget)
    cc = _cam32().device_constants("cuda")
    cfg = bdpt.BDPTConfig(32, 32, spp=4, rr_depth=4)
    key = rng.key(7, "cuda")

    def chunk(b):
        def render():
            fb, nrays = bdpt.render_chunk(cuda_scene, cc, cfg, key, cfg.spp,
                                          samples_per_batch=b)
            return fb, int(nrays)
        return render

    kernel, plain, launches = _kernel_and_plain(chunk(sb), K12)
    batches = cfg.spp // sb
    assert (launches["k1_closest_hit"], launches["k2_any_hit"]) == (
        4 * batches, 4 * batches)
    _assert_agree(kernel, plain)
    if sb == 4:
        with _launched(*K12) as two:
            unchunked = chunk(2)()
        assert (two["k1_closest_hit"], two["k2_any_hit"]) == (8, 2)
        _assert_agree(kernel, unchunked)


@pytest.fixture(scope="module")
def cuda_box():
    """The glass box on the card with its SceneMeta, and a 32x32 camera."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    return cornell_box_scene(32, 32, device="cuda",
                             right_object="glass_sphere", sphere_subdiv=3)


def _path(**kw):
    from bpt_tpu_torch.integrators.path import PathConfig, render_image_path

    return lambda scene, meta, cam: render_image_path(
        scene, cam, PathConfig(32, 32, spp=2, **kw), seed=1)


def _direct(strategy):
    from bpt_tpu_torch.integrators.direct import DirectConfig, \
        render_image_direct

    return lambda scene, meta, cam: render_image_direct(
        scene, meta, cam, DirectConfig(32, 32, 2, strategy=strategy), seed=1)


def _misc(integrator):
    from bpt_tpu_torch.integrators.misc import MiscConfig, render_image_misc

    return lambda scene, meta, cam: render_image_misc(
        scene, meta, cam, MiscConfig(32, 32, 2, integrator=integrator),
        seed=1)


INTEGRATORS = {
    "path": (_path, dict(max_bounces=8, rr_depth=3)),
    "path_mis": (_path, dict(max_bounces=4, bsdf_samples=1)),
    "path_implicit": (_path, dict(is_explicit=False, max_depth=4)),
    **{f"direct_{s}": (_direct, s) for s in (
        "area", "solidAngle", "cosineHemisphere", "bsdf", "mis")},
    **{f"misc_{m}": (_misc, m) for m in ("normal", "simple", "ao", "ro")},
}


# The integrators that trace occlusion through K2; the others take K1
# alone.
OCCLUSION = ("misc_simple", "misc_ao", "misc_ro")


@pytest.mark.parametrize("name", list(INTEGRATORS))
def test_integrator_renders_through_the_kernels(cuda_box, name):
    """Each integrator of path.py, direct.py and misc.py renders through
    K1 (and K2 where it traces occlusion) within the aggregate gate of
    its render through the plain versions."""
    make, arg = INTEGRATORS[name]
    render = make(**arg) if isinstance(arg, dict) else make(arg)
    kernel, plain, _ = _kernel_and_plain(
        lambda: render(*cuda_box),
        K12 if name in OCCLUSION else ("k1_closest_hit",))
    _assert_agree(kernel, plain)


GRAD_MODES = {"bdpt": {}, "path_trace": dict(mode="path_trace"),
              "light_trace": dict(mode="light_trace"),
              "rr": dict(no_rr=False, rr_depth=2, max_bounces=6)}


@pytest.mark.parametrize("mode", list(GRAD_MODES))
def test_gradient_through_the_kernels(cuda_box, mode):
    """Gradients of each estimator and of Russian roulette through K1/K2
    and G1 (32x32, 4 spp in chunks of 2, key 11): finite, an emission
    gradient, each field within 1e-4 of its norm of the gradient through
    the plain versions; for BDPT also tests/test_grad.py's
    finite-difference check (eps 1e-2, rtol 0.05, atol 1e-4) of the
    floor's red albedo and the light's green emission."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.diff.grad import extract_params, \
        finite_difference_check
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig

    scene, _, cam = cuda_box
    cc = cam.device_constants("cuda")
    cfg = BDPTConfig(32, 32, **{"spp": 4, "rr_depth": 3, **GRAD_MODES[mode]})
    key = rng.key(11, "cuda")
    g, _ = _grad_kernel_and_plain(scene, cc, cfg, key, 2, _k12_plain(),
                                  (*K12, G1))
    if mode != "bdpt":
        return
    params = extract_params(scene)
    target = torch.zeros((32 * 32, 3), device="cuda")
    for field, idx in (("diffuse", (0, 0)), ("emission", (5, 1))):
        fd = float(finite_difference_check(params, scene, cc, cfg, key, 2,
                                           target, field, idx, eps=1e-2))
        ad = float(g[field][idx])
        assert abs(fd - ad) <= 1e-4 + 0.05 * abs(ad), (field, fd, ad)


@pytest.mark.parametrize("pass_type", ["normal", "simple", "ssao", "gi"])
def test_realtime_pass_through_the_kernels(cuda_box, pass_type):
    """Two frames of each realtime pass through K1 (and K2 where the pass
    traces occlusion) equal the same frames through the plain versions,
    pixel for pixel."""
    from unittest import mock

    from bpt_tpu_torch import realtime
    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.ops.trace_any import any_hit_plain
    from bpt_tpu_torch.ops.trace_closest import closest_hit_plain
    from bpt_tpu_torch.scene.toml_config import RenderConfig

    scene, meta, cam = cuda_box
    cfg_t = RenderConfig(toml_file="<test>", obj_file="<proc>", camera=cam,
                         width=32, height=32, spp=2, integrator=pass_type,
                         realtime=True, rr_depth=3)
    with _launched(*(K12 if pass_type in ("simple", "ssao")
                     else ("k1_closest_hit",))) as launches:
        a, frames, na = realtime.run_realtime(
            scene, meta, cfg_t, "unused.exr", seed=2,
            write_exr=lambda *_: None)
    assert frames == 2 and launches["k1_closest_hit"] >= 2
    assert a.device.type == "cuda" and torch.isfinite(a).all()
    with mock.patch.object(api, "closest_hit", closest_hit_plain), \
            mock.patch.object(api, "any_hit", any_hit_plain):
        b, _, nb = realtime.run_realtime(scene, meta, cfg_t, "unused.exr",
                                         seed=2, write_exr=lambda *_: None)
    assert na == nb
    off = (a - b).abs() > 1e-3 * torch.clamp_min(b.abs(), 1e-3)
    assert not bool(off.any())


@pytest.fixture(scope="module")
def cuda_subdiv5():
    """The glass box at subdiv 5 (235 treelets): groups of 8, 64 and
    STREAM_CHUNK leave a ragged last group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, _ = cornell_box_scene(16, 16, device="cuda",
                                    right_object="glass_sphere",
                                    sphere_subdiv=5)
    return scene


@pytest.mark.parametrize("chunk", [8, 64, STREAM_CHUNK])
@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_closest_stream_kernel_bit_equal_to_plain(cuda_subdiv5, n, chunk):
    from bpt_tpu_torch.ops.trace_closest import closest_hit_stream, \
        closest_hit_stream_plain

    tg = cuda_subdiv5.treelets
    args = _rays(n, seed=n + chunk)
    launches = closest_hit_stream.launches
    got = closest_hit_stream(tg, *args, chunk)
    ref = closest_hit_stream_plain(tg, *args, chunk)
    torch.cuda.synchronize()
    assert closest_hit_stream.launches == launches + 1
    assert torch.equal(got[1], ref[1])
    for g, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("chunk", [8, 64, STREAM_CHUNK])
@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_any_stream_kernel_equal_to_plain(cuda_subdiv5, n, chunk):
    from bpt_tpu_torch.ops.trace_any import any_hit_stream, \
        any_hit_stream_plain

    tg = cuda_subdiv5.treelets_any
    args = _rays(n, seed=n + chunk + 1, segment=True)
    launches = any_hit_stream.launches
    got = any_hit_stream(tg, *args, chunk)
    ref = any_hit_stream_plain(tg, *args, chunk)
    torch.cuda.synchronize()
    assert any_hit_stream.launches == launches + 1
    assert torch.equal(got, ref)


def test_stream_kernels_match_k1_k2_on_the_bench_scene(cuda_scene):
    """19 treelets in groups of 8: K3 is K1 bit for bit on every lane (t,
    tri, u and v), and K4's flags are K2's."""
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_stream
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_stream

    args = _rays(65_536, seed=3)
    _bit_equal_closest(closest_hit_stream(cuda_scene.treelets, *args, 8),
                       closest_hit(cuda_scene.treelets, *args))
    seg = _rays(65_536, seed=4, segment=True)
    assert torch.equal(any_hit_stream(cuda_scene.treelets_any, *seg, 8),
                       any_hit(cuda_scene.treelets_any, *seg))


@pytest.fixture(scope="module")
def cuda_large_file(tmp_path_factory):
    """The glass box at subdiv 7 (327,704 triangles, 3,656 treelets, the
    large scene of the main path) as a user brings it: written as TOML +
    OBJ/MTL at 32x32 and read back through load_toml and load_scene.
    (scene, meta, the scene file's RenderConfig)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.scene.export import export_cornell_box
    from bpt_tpu_torch.scene.scene import load_scene
    from bpt_tpu_torch.scene.toml_config import load_toml

    cfg_t = load_toml(export_cornell_box(
        str(tmp_path_factory.mktemp("large")), width=32, height=32,
        right_object="glass_sphere", sphere_subdiv=7))
    scene, meta = load_scene(cfg_t.obj_file, "cuda")
    assert meta.n_triangles == 327_704
    assert scene.treelets.block.shape[0] == 3_656
    return scene, meta, cfg_t


@pytest.fixture(scope="module")
def cuda_large(cuda_large_file):
    return cuda_large_file[0]


@pytest.mark.parametrize("table", ["cuda_scene", "cuda_large"])
def test_stream_kernels_bit_equal_to_k1_k2_plain(request, table):
    """K3 at the route's group size is K1's plain version bit for bit,
    and K4's flags are K2's plain version's, on the bench table and on
    the large scene's table."""
    from bpt_tpu_torch.ops.trace_any import any_hit_plain, any_hit_stream
    from bpt_tpu_torch.ops.trace_closest import closest_hit_plain, \
        closest_hit_stream

    scene = request.getfixturevalue(table)
    args = _rays(65_536, seed=13)
    _bit_equal_closest(closest_hit_stream(scene.treelets, *args, STREAM_CHUNK),
                       closest_hit_plain(scene.treelets, *args))
    seg = _rays(65_536, seed=14, segment=True)
    occ = any_hit_stream(scene.treelets_any, *seg, STREAM_CHUNK)
    assert torch.equal(occ, any_hit_plain(scene.treelets_any, *seg))
    assert 0 < int(occ.sum()) < int((seg[3] >= seg[2]).sum())


def test_stream_kernels_above_the_shared_memory_budget(cuda_subdiv5):
    """About 12,000 treelets (the 235-treelet table repeated): too many
    member boxes for shared memory, so K3 and K4 read them from global
    memory behind the resident group boxes.  K3 is K1's plain version
    bit for bit and K4's flags are K2's plain version's.  With groups of
    one treelet the group boxes alone exceed what a block may hold, and
    both wrappers raise instead of launching."""
    from bpt_tpu_torch.ops.trace_any import any_hit_plain, any_hit_stream
    from bpt_tpu_torch.ops.trace_closest import closest_hit_plain, \
        closest_hit_stream

    big = _repeated(cuda_subdiv5.treelets, 12_000)
    big_any = _repeated(cuda_subdiv5.treelets_any, 12_000)
    assert big.block.shape[0] == 12_220
    args = _rays(4_096, seed=15)
    _bit_equal_closest(closest_hit_stream(big, *args, STREAM_CHUNK),
                       closest_hit_plain(big, *args))
    seg = _rays(4_096, seed=16, segment=True)
    assert torch.equal(any_hit_stream(big_any, *seg, STREAM_CHUNK),
                       any_hit_plain(big_any, *seg))
    for fn, tg, a in ((closest_hit_stream, big, args),
                      (any_hit_stream, big_any, seg)):
        launches = fn.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(tg, *a, 1)
        assert fn.launches == launches


def _repeated(tg, n):
    """A table of at least n treelets: tg's rows repeated."""
    reps = -(-n // tg.block.shape[0])
    return type(tg)(*(x.repeat((reps,) + (1,) * (x.ndim - 1)).contiguous()
                      for x in tg))


def test_unstreamed_kernels_refuse_large_tables(cuda_subdiv5):
    """K1/K2 and K5-K7 take at most MAX_TREELETS treelets on the card; a
    larger table raises instead of reaching a plain version."""
    from bpt_tpu_torch.ops.intersect import MAX_TREELETS
    from bpt_tpu_torch.ops.trace_any import any_hit
    from bpt_tpu_torch.ops.trace_closest import closest_hit

    from bpt_tpu_torch.ops.trace_any import any_hit_compact
    from bpt_tpu_torch.ops.trace_closest import closest_hit_full, \
        closest_hit_sweep

    big = _repeated(cuda_subdiv5.treelets, MAX_TREELETS + 1)
    args = _rays(64, seed=5)
    for fn in (closest_hit, any_hit, closest_hit_full, closest_hit_sweep,
               any_hit_compact):
        launches = fn.launches
        with pytest.raises(ValueError):
            fn(big, *args)
        assert fn.launches == launches


@pytest.fixture(scope="module")
def cuda_subdiv6():
    """The glass box at subdiv 6 (923 treelets): its packed triangle rows
    (3.9 MB) do not fit in shared memory, where the bench table's do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, _ = cornell_box_scene(16, 16, device="cuda",
                                    right_object="glass_sphere",
                                    sphere_subdiv=6)
    assert scene.treelets.block.shape[0] == 923
    return scene


TABLES = ["cuda_scene", "cuda_subdiv5", "cuda_subdiv6"]


def _flat_kernels_equal_plain(tg, tg_any, n, seed, live_frac=0.6):
    """K1 bit-equal to its plain version and K2's flags equal to its
    plain version's on n rays and n segments."""
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_plain

    args = _rays(n, seed=seed)
    seg = _rays(n, seed=seed + 1, segment=True)
    if live_frac == 0.0:
        args = args[:3] + (torch.full_like(args[3], -1.0),)
        seg = seg[:3] + (torch.full_like(seg[3], -1.0),)
    got = closest_hit(tg, *args)
    occ = any_hit(tg_any, *seg)
    torch.cuda.synchronize()
    _bit_equal_closest(got, closest_hit_plain(tg, *args))
    assert torch.equal(occ, any_hit_plain(tg_any, *seg))
    return got, occ


@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_flat_kernels_on_the_923_treelet_table(cuda_subdiv6, n):
    """K1 and K2 with their triangle rows read from global memory."""
    got, occ = _flat_kernels_equal_plain(cuda_subdiv6.treelets,
                                         cuda_subdiv6.treelets_any, n, 40 + n)
    if n > 1:
        assert int((got[1] >= 0).sum()) > 0 and 0 < int(occ.sum()) < n


def test_flat_kernels_with_every_lane_dead(cuda_scene):
    got, occ = _flat_kernels_equal_plain(cuda_scene.treelets,
                                         cuda_scene.treelets_any, 5000, 50,
                                         live_frac=0.0)
    assert int((got[1] >= 0).sum()) == 0 and int(occ.sum()) == 0


@pytest.mark.parametrize("table", ["one_treelet", "limit_2048"])
def test_flat_kernels_on_edge_tables(cuda_scene, table):
    """A table of one treelet, and the largest table K1 and K2 take:
    2,048 treelets, one with all 128 slots filled, most with none."""
    import chip_smoke
    from bpt_tpu_torch.accel.treelets import triangle_counts
    from bpt_tpu_torch.ops.intersect import MAX_TREELETS

    tg = chip_smoke.edge_tables(cuda_scene.treelets, MAX_TREELETS)[table]
    if table != "one_treelet":
        counts = triangle_counts(tg)
        assert tg.block.shape[0] == MAX_TREELETS
        assert (int(counts.min()), int(counts.max())) == (0, 128)
    got, occ = _flat_kernels_equal_plain(tg, tg, 50_000, 60)
    assert int((got[1] >= 0).sum()) > 0 and int(occ.sum()) > 0


def _bit_equal_closest(got, ref):
    assert torch.equal(got[1], ref[1])
    for g, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_full_kernel_bit_equal_to_plain_and_k1(request, table, n):
    """K5 (19 treelets: one run, the rows in shared memory; 235 and 923:
    several runs, the rows read from device memory) against its plain
    version and K1, bit for bit."""
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_full, closest_hit_full_plain

    tg = request.getfixturevalue(table).treelets
    args = _rays(n, seed=n + 7)
    launches = closest_hit_full.launches
    got = closest_hit_full(tg, *args)
    ref = closest_hit_full_plain(tg, *args)
    k1 = closest_hit(tg, *args)
    torch.cuda.synchronize()
    assert closest_hit_full.launches == launches + 1
    _bit_equal_closest(got, ref)
    _bit_equal_closest(got, k1)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_sweep_kernel_bit_equal_to_plain(request, table, n):
    """K6 against its plain version bit for bit; its t is K1's on every
    lane, and tri/u/v differ from K1's only on exact-t ties."""
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_sweep, closest_hit_sweep_plain

    tg = request.getfixturevalue(table).treelets
    args = _rays(n, seed=n + 8)
    launches = closest_hit_sweep.launches
    got = closest_hit_sweep(tg, *args)
    ref = closest_hit_sweep_plain(tg, *args)
    k1 = closest_hit(tg, *args)
    torch.cuda.synchronize()
    assert closest_hit_sweep.launches == launches + 1
    _bit_equal_closest(got, ref)
    assert torch.equal(got[0].view(torch.int32), k1[0].view(torch.int32))
    assert float((got[1] != k1[1]).double().mean()) <= 0.02


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_compact_any_kernel_equal_to_plain_and_k2(request, table, n):
    """K7 (235 treelets: unions of more than one round) against its plain
    version and K2, flag for flag."""
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_compact, \
        any_hit_compact_plain

    tg = request.getfixturevalue(table).treelets_any
    args = _rays(n, seed=n + 9, segment=True)
    launches = any_hit_compact.launches
    got = any_hit_compact(tg, *args)
    ref = any_hit_compact_plain(tg, *args)
    k2 = any_hit(tg, *args)
    torch.cuda.synchronize()
    assert any_hit_compact.launches == launches + 1
    assert torch.equal(got, ref)
    assert torch.equal(got, k2)


def _pool_render(scene, cam, cfg, seed):
    """cfg.spp pooled samples of render_sample_pool, the whole pool in one
    pass: (fb (W*H, 3), nrays)."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import render_sample_pool

    cc = cam.device_constants("cuda")
    key = rng.key(seed, "cuda")
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                       device="cuda")
    pids = torch.arange(cfg.light_pool, dtype=torch.int32, device="cuda")
    fb, nrays = 0.0, 0
    for s in range(cfg.spp):
        fb_s, nr = render_sample_pool(scene, cc, cfg, rng.fold_in(key, s),
                                      pix, pids)
        fb, nrays = fb + fb_s, nrays + int(nr)
    return fb, nrays


def test_pooled_render_through_the_kernels(cuda_box):
    """Pooled light transport (32x32, a pool of 32, rr_depth 4) through
    K1/K2, in connect chunks of the default budget, against the render
    through their plain versions; every pool pass launches K2."""
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig

    scene, _, cam = cuda_box
    cfg = BDPTConfig(32, 32, spp=2, rr_depth=4, light_pool=32)
    kernel, plain, launches = _kernel_and_plain(
        lambda: _pool_render(scene, cam, cfg, seed=3), K12)
    # Per sample: primaries, 3 pool and 3 eye walk depths through K1; 3
    # t=1, 3 NEE and one connect_pool chunk through K2.
    assert launches["k1_closest_hit"] == 7 * cfg.spp
    assert launches["k2_any_hit"] == 7 * cfg.spp
    _assert_agree(kernel, plain)


def test_mesh_at_world_size_one_over_nccl(cuda_box, tmp_path):
    """parallel/mesh.py on the card: a world of one rank over NCCL, both
    framebuffer merges of render_image_sharded against render_image, and
    the pool ring (one pass) against the single-device pooled render."""
    import torch.distributed as dist

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu_torch.parallel import mesh as pm

    scene, _, cam = cuda_box
    device = pm.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                                 backend="nccl")
    try:
        mesh = pm.make_mesh()
        assert (mesh.n_dp, mesh.n_sp, mesh.device) == (1, 1, device)
        cfg = BDPTConfig(32, 32, spp=2, rr_depth=4)
        want = render_image(scene, cam, cfg, seed=1)
        for mode in pm.FB_MODES:
            with _launched(*K12):
                got = pm.render_image_sharded(scene, cam, cfg, mesh, seed=1,
                                              fb_mode=mode)
            assert got[0].device == device
            _assert_agree(got, want)
        cfg = BDPTConfig(32, 32, spp=2, rr_depth=4, light_pool=32)
        with _launched(*K12):
            fb, nr = pm.render_chunk_pool_ring(
                scene, cam.device_constants("cuda"), cfg, mesh,
                rng.key(3, "cuda"), cfg.spp)
        _assert_agree((fb, int(nr)), _pool_render(scene, cam, cfg, seed=3))
    finally:
        dist.destroy_process_group()


def _tile_kernels_equal_plain(tg, args, seg):
    """K6 bit-equal to its plain version with K1's t, and K7's flags equal
    to its plain version's and K2's, on rays `args` and segments `seg`."""
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_compact, \
        any_hit_compact_plain
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_sweep, closest_hit_sweep_plain

    got = closest_hit_sweep(tg, *args)
    occ = any_hit_compact(tg, *seg)
    torch.cuda.synchronize()
    _bit_equal_closest(got, closest_hit_sweep_plain(tg, *args))
    assert torch.equal(got[0].view(torch.int32),
                       closest_hit(tg, *args)[0].view(torch.int32))
    assert torch.equal(occ, any_hit_compact_plain(tg, *seg))
    assert torch.equal(occ, any_hit(tg, *seg))
    return got, occ


@pytest.mark.parametrize("table", ["one_treelet", "limit_2048"])
def test_tile_kernels_on_edge_tables(cuda_scene, table):
    """K6 and K7 on a table of one treelet, and on the largest table they
    take: 2,048 treelets, one with all 128 slots filled, most with none."""
    import chip_smoke

    from bpt_tpu_torch.ops.intersect import MAX_TREELETS

    tg = chip_smoke.edge_tables(cuda_scene.treelets, MAX_TREELETS)[table]
    got, occ = _tile_kernels_equal_plain(
        tg, _rays(50_000, seed=70), _rays(50_000, seed=71, segment=True))
    assert int((got[1] >= 0).sum()) > 0 and int(occ.sum()) > 0


def test_tile_kernels_on_unions_wider_than_the_block(cuda_subdiv6):
    """Tiles whose union holds more treelets than the block has threads
    (128): the union is listed in several rounds and K6 sorts more keys
    than one a thread.  Rays and segments from anywhere in the box aim at
    points in the box of the sphere's treelets (those below the median
    size), so a tile of them crosses hundreds of the 923."""
    from bpt_tpu_torch.ops.intersect import slab

    tg = cuda_subdiv6.treelets
    n = 8 * 128
    size = (tg.bmax - tg.bmin).amax(dim=1)
    small = size <= size.median()
    lo, hi = tg.bmin[small].amin(dim=0), tg.bmax[small].amax(dim=0)
    o, _, mn, mx = _rays(n, seed=72)
    gen = torch.Generator(device="cuda").manual_seed(73)
    aim = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device="cuda")
    dist = torch.linalg.vector_norm(aim - o, dim=-1)
    d = (aim - o) / dist[:, None]
    args, seg = (o, d, mn, mx), (o, d, mn, dist)
    for rays in (args, seg):
        mask, _ = slab(tg.bmin, tg.bmax, *rays)
        union = mask.view(n // 128, 128, -1).any(dim=1).sum(dim=1)
        assert int(union.min()) > 128
    got, occ = _tile_kernels_equal_plain(tg, args, seg)
    assert int((got[1] >= 0).sum()) > 0 and 0 < int(occ.sum()) < n


def _zero_entry_table():
    """Two treelets that hold the same triangle (in the plane z = -0.5)
    under triangle indices 10 and 20.  Lane 0 starts at (0, 0, 0.5) going
    down: it lies on the top face of treelet 0's box, so its slab entry
    there is max(-0.0, 0) = -0.0 in the plain versions, and strictly
    inside treelet 1's box (entry +0.0).  The two entries compare equal,
    so the lower index, treelet 0, is visited first and its triangle (10)
    wins the exact-t tie; an order by the entries' raw bits would put
    -0.0 after +0.0 and keep 20.  Lane 1 is dead.  K = 4, three slots
    empty (degenerate, index 99)."""
    k = 4
    tri = np.array([-1.0, -1.0, -0.5, 3.0, 0.0, 0.0, 0.0, 3.0, 0.0])
    block = np.zeros((2, 9, k), np.float32)
    block[:, :, 0] = tri
    tri_index = np.full((2, k), 99, np.int32)
    tri_index[:, 0] = [10, 20]
    bmin = np.array([[-1, -1, -1], [-1, -1, -1]], np.float32)
    bmax = np.array([[2, 2, 0.5], [2, 2, 1]], np.float32)
    o = np.array([[0, 0, 0.5], [0, 0, 0.5]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
    mn = np.full(2, 1e-8, np.float32)
    mx = np.array([np.inf, -1.0], np.float32)
    return (bmin, bmax, tri_index, block), (o, d, mn, mx)


def _tie_table():
    """Two treelets that hold the same triangle (in the plane z = 0, over
    the origin) under different triangle indices, 10 and 20.  Lane 0 comes
    down the z axis from z = 5: it enters treelet 0 at t = 1 and treelet 1
    at t = 4.9, so its own order visits 0 first.  Lane 1 comes down at
    x = 5, where only treelet 1 reaches: it enters 1 at t = 0.9 and misses
    the triangle.  The tile's minimum entries are 1 for treelet 0 and 0.9
    for treelet 1, so the tile visits 1 first.  K = 4, three slots empty
    (degenerate, index 99)."""
    k = 4
    v0 = np.array([-1.0, -1.0, 0.0])
    e1 = np.array([3.0, 0.0, 0.0])
    e2 = np.array([0.0, 3.0, 0.0])
    block = np.zeros((2, 9, k), np.float32)
    block[:, :, 0] = np.concatenate([v0, e1, e2])
    tri_index = np.full((2, k), 99, np.int32)
    tri_index[:, 0] = [10, 20]
    bmin = np.array([[-1, -1, -0.1], [-1, -1, -0.1]], np.float32)
    bmax = np.array([[2, 2, 4], [6, 2, 0.1]], np.float32)
    o = np.array([[0, 0, 5], [5, 0, 1]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
    mn = np.full(2, 1e-8, np.float32)
    mx = np.full(2, np.inf, np.float32)
    return (bmin, bmax, tri_index, block), (o, d, mn, mx)


def _list_keys():
    """The keys a lane's list holds in K5 (kListKeys of
    csrc/closest_hit_full.cu)."""
    import re

    from bpt_tpu_torch.ops import _build

    src = (_build.CSRC / "closest_hit_full.cu").read_text()
    return int(re.search(r"constexpr int kListKeys = (\d+);", src).group(1))


OVERFLOW_NT = 40


def _overflow_table(ns):
    """A stack of OVERFLOW_NT treelets (two runs of 32, the second
    ragged): treelet i's box is x, y in [-4, 4], z in [i, i + 1], and it
    holds one triangle, index 100 + i, in the plane z = i + 0.5 over the
    cell of grid point ((i % 7) - 3, (i // 7) - 3), with three pad slots
    (index 99).  Rays go up from z = -0.5, so treelet i's entry is
    i + 0.5, and max_t = n - 0.25 makes a ray overlap treelets 0..n-1
    exactly.  For each n of `ns`: a ray aimed at triangle 0 (one visit),
    one at triangle n - 2 (n - 1 visits) and one between the cells (it
    misses after n visits); then, with max_t = inf (all OVERFLOW_NT
    treelets), one aimed at triangle 30 and one that misses; and a dead
    lane.  Returns (table, rays, each lane's overlapped treelets, each
    lane's expected triangle index)."""
    nt, k = OVERFLOW_NT, 4
    grid = np.stack([np.arange(nt) % 7 - 3.0, np.arange(nt) // 7 - 3.0], 1)
    block = np.zeros((nt, 9, k), np.float32)
    block[:, 0:2, 0] = grid - 0.4
    block[:, 2, 0] = np.arange(nt) + 0.5
    block[:, 3, 0] = 0.8
    block[:, 7, 0] = 0.8
    tri_index = np.full((nt, k), 99, np.int32)
    tri_index[:, 0] = 100 + np.arange(nt)
    bmin = np.stack([np.full(nt, -4.0), np.full(nt, -4.0),
                     np.arange(nt, dtype=np.float64)], 1).astype(np.float32)
    bmax = np.stack([np.full(nt, 4.0), np.full(nt, 4.0),
                     np.arange(nt) + 1.0], 1).astype(np.float32)
    lanes = []  # (max_t, treelets overlapped, triangle aimed at)
    for n in ns:
        for aim in (0, n - 2, None):
            lanes.append((n - 0.25, n, aim))
    lanes += [(np.inf, nt, 30), (np.inf, nt, None), (-1.0, 0, None)]
    o = np.zeros((len(lanes), 3), np.float32)
    for i, (_, _, aim) in enumerate(lanes):
        o[i, :2] = grid[0] + 0.5 if aim is None else grid[aim] - 0.2
    o[:, 2] = -0.5
    d = np.tile(np.array([[0, 0, 1]], np.float32), (len(lanes), 1))
    mn = np.full(len(lanes), 1e-8, np.float32)
    mx = np.array([m for m, _, _ in lanes], np.float32)
    return ((bmin, bmax, tri_index, block), (o, d, mn, mx),
            [c for _, c, _ in lanes],
            [-1 if aim is None else 100 + aim for _, _, aim in lanes])


K5_INPUTS = ["bench", "subdiv6", "zero_entries", "tie", "dead_lanes",
             "no_lanes", "overflow_boundary"]


@pytest.mark.parametrize("case", K5_INPUTS)
def test_full_kernel_bit_equal_on_every_input(request, case):
    """K5 bit-equal to its plain version and to K1 in (t, tri, u, v): on
    the bench table and the 923-treelet table, the zero-entry and tie
    tables, a batch of dead lanes, no lanes, and the overflow table with
    rays that overlap C - 1, C and C + 1 treelets (C the keys a lane's
    list holds) and all 40: exactly the lanes past C take K1's walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.accel.treelets import TreeletGeom
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_full, closest_hit_full_plain

    want_tri = counts = None
    if case in ("bench", "dead_lanes", "no_lanes"):
        tg = request.getfixturevalue("cuda_scene").treelets
        n = {"bench": 65_536, "dead_lanes": 5000, "no_lanes": 0}[case]
        rays = _rays(n, seed=80)
        if case == "dead_lanes":
            rays = rays[:3] + (torch.full_like(rays[3], -1.0),)
    elif case == "subdiv6":
        tg = request.getfixturevalue("cuda_subdiv6").treelets
        rays = _rays(65_536, seed=81)
    else:
        if case == "overflow_boundary":
            c = _list_keys()
            table, rays, counts, want_tri = _overflow_table([c - 1, c, c + 1])
        else:
            table, rays = {"zero_entries": _zero_entry_table,
                           "tie": _tie_table}[case]()
            want_tri = [10, -1]
        tg = TreeletGeom(*(torch.from_numpy(x).cuda() for x in table))
        rays = tuple(torch.from_numpy(x).cuda() for x in rays)
    launches = closest_hit_full.launches
    got = closest_hit_full(tg, *rays)
    ref = closest_hit_full_plain(tg, *rays)
    k1 = closest_hit(tg, *rays)
    torch.cuda.synchronize()
    b = rays[0].shape[0]
    assert closest_hit_full.launches == launches + int(b > 0)
    _bit_equal_closest(got, ref)
    _bit_equal_closest(got, k1)
    if want_tri is not None:
        assert got[1].tolist() == want_tri
    if counts is not None:
        over = sum(n > _list_keys() for n in counts)
        assert int(closest_hit_full.overflow_lanes) == over > 0
    if case == "dead_lanes":
        assert int((got[1] >= 0).sum()) == 0
    elif case in ("bench", "subdiv6"):
        assert int((got[1] >= 0).sum()) > 0


def test_tile_kernels_on_zero_entries():
    """The zero-entry table (_zero_entry_table) on the card: a lane
    whose entries to two treelets are both zero, one of them -0.0.  K6
    and K5 keep the lower-indexed treelet's triangle on the exact-t tie,
    bit-equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.accel.treelets import TreeletGeom
    from bpt_tpu_torch.ops.trace_closest import closest_hit_full, \
        closest_hit_full_plain, closest_hit_sweep, closest_hit_sweep_plain

    table, rays = _zero_entry_table()
    tg = TreeletGeom(*(torch.from_numpy(x).cuda() for x in table))
    rays = tuple(torch.from_numpy(x).cuda() for x in rays)
    for kernel, plain in ((closest_hit_sweep, closest_hit_sweep_plain),
                          (closest_hit_full, closest_hit_full_plain)):
        got = kernel(tg, *rays)
        torch.cuda.synchronize()
        _bit_equal_closest(got, plain(tg, *rays))
        assert got[1].tolist() == [10, -1]


def _stream_routes():
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc

    return {"closest_hit_stream": tc.closest_hit_stream_plain,
            "any_hit_stream": ta.any_hit_stream_plain}


def _grad_kernel_and_plain(scene, cc, cfg, key, spp_chunk, routes, used):
    """loss_and_grad through the kernels, held by _launched(*used), and
    through the plain `routes` and G1's plain version; each field's
    gradient held finite and within 1e-4 of its norm of the plain one.
    Returns the kernels' gradients and their launches."""
    from unittest import mock

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.diff.grad import extract_params, loss_and_grad
    from bpt_tpu_torch.ops import gather

    params = extract_params(scene)
    target = torch.zeros((cfg.width * cfg.height, 3), device="cuda")
    with _launched(*used) as launches:
        _, g = loss_and_grad(params, scene, cc, cfg, key, spp_chunk, target)
    with mock.patch.multiple(api, **routes), mock.patch.object(
            gather, "gather_rows_backward",
            lambda ids, grads, m: gather.gather_rows_backward_plain(
                ids.long(), grads, m)):
        _, g_plain = loss_and_grad(params, scene, cc, cfg, key, spp_chunk,
                                   target)
    for f, v in g.items():
        assert torch.isfinite(v).all()
        assert float(torch.linalg.vector_norm((v - g_plain[f]).double())) \
            <= 1e-4 * float(torch.linalg.vector_norm(g_plain[f].double()))
    assert float(g["emission"].abs().sum()) > 0.0
    return g, launches


def _large_render(case, scene, meta, cam):
    """A 32x32 render of the large scene by `case`: () -> (img, nrays)."""
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu_torch.integrators.misc import MiscConfig, render_image_misc
    from bpt_tpu_torch.integrators.path import PathConfig, render_image_path

    if case == "bdpt":
        cfg = BDPTConfig(32, 32, spp=2, rr_depth=4)
        return lambda: render_image(scene, cam, cfg, seed=7)
    if case == "path":
        cfg = PathConfig(32, 32, 2)
        return lambda: render_image_path(scene, cam, cfg, seed=7)
    if case == "ao":
        cfg = MiscConfig(32, 32, 2, integrator="ao")
        return lambda: render_image_misc(scene, meta, cam, cfg, seed=7)
    cfg = BDPTConfig(32, 32, spp=2, rr_depth=8, light_pool=16)
    return lambda: _pool_render(scene, cam, cfg, seed=7)


@pytest.mark.parametrize("case", ["bdpt", "path", "ao", "pool", "grad"])
def test_large_scene_file_through_the_stream_kernels(cuda_large_file, case):
    """The large scene read from its scene file (3,656 treelets, past
    what K1 and K2 take) through K3 (and K4 where the case traces
    occlusion), never K1 or K2: BDPT (2 spp, one a batch, rr_depth 4:
    4 K3 and 1 K4 launches a batch), the path tracer with the scene
    file's defaults, ao and the pool (16 light paths) held to their
    renders through K3's and K4's plain versions by the aggregate gate,
    and BDPT's gradients (1 spp) held to the plain versions'."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig

    scene, meta, cfg_t = cuda_large_file
    cam = cfg_t.camera
    if case == "grad":
        _grad_kernel_and_plain(
            scene, cam.device_constants("cuda"),
            BDPTConfig(32, 32, spp=1, rr_depth=3), rng.key(11, "cuda"), 1,
            _stream_routes(), (*K34, G1))
        return
    kernel, plain, launches = _kernel_and_plain(
        _large_render(case, scene, meta, cam),
        K34 if case != "path" else K34[:1], _stream_routes())
    if case == "bdpt":
        assert (launches["k3_closest_hit_stream"],
                launches["k4_any_hit_stream"]) == (2 * 4, 2)
    _assert_agree(kernel, plain)


def _z(a, b):
    """|z| of the difference of two lists of replicate means."""
    se2 = lambda m: float(np.var(m, ddof=1)) / len(m)
    return abs(float(np.mean(a)) - float(np.mean(b))) / (
        se2(a) + se2(b) + 1e-30) ** 0.5


def _means(render, seeds=range(100, 106)):
    """Image means of render(key) over 6 disjoint seeds, each image
    finite and non-negative."""
    from bpt_tpu_torch.core import rng

    means = []
    for seed in seeds:
        fb, _ = render(rng.key(seed, "cuda"))
        assert torch.isfinite(fb).all() and float(fb.min()) >= 0.0
        means.append(float(fb.double().mean()))
    return means


ESTIMATOR_CASES = {
    # Without roulette at rr_depth 3 BDPT estimates another truncation
    # (PERF.md section 6): only the path and light tracers must agree.
    "no_rr": (dict(rr_depth=3), [("path_trace", "light_trace")]),
    "no_rr_deep": (dict(rr_depth=16), None),
    "rr": (dict(rr_depth=3, no_rr=False, max_bounces=16), None),
}


@pytest.mark.parametrize("case", [*ESTIMATOR_CASES, "path_vs_bdpt",
                                  "pool_of_w_h"])
def test_estimators_agree_through_the_kernels(case):
    """tests/test_bdpt.py's cross-estimator check on the card, through
    K1/K2: image means of the all-diffuse box (64x64, 8 spp in one
    batch, 6 seeds from 100) held to |z| < 4 between BDPT, the path
    tracer and the light tracer (without roulette at rr_depth 3 and 16,
    with roulette to 16 bounces); the explicit path tracer (one emitter
    and one BSDF sample, roulette from depth 5) against BDPT with
    roulette; the pooled estimator at a pool of W*H paths against
    per-pixel BDPT (4 spp, rr_depth 3)."""
    from itertools import combinations

    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk
    from bpt_tpu_torch.integrators.path import PathConfig, render_chunk_path
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    w, spp = 64, 8
    scene, _, cam = cornell_box_scene(w, w, device="cuda")
    cc = cam.device_constants("cuda")

    def chunk(cfg):
        return lambda key: render_chunk(scene, cc, cfg, key, cfg.spp,
                                        samples_per_batch=cfg.spp)

    def estimate():
        if case in ESTIMATOR_CASES:
            extra, pairs = ESTIMATOR_CASES[case]
            modes = ("bdpt", "path_trace", "light_trace")
            means = {m: _means(chunk(BDPTConfig(w, w, spp=spp, mode=m,
                                                **extra)))
                     for m in modes}
            pairs = pairs or list(combinations(modes, 2))
        elif case == "path_vs_bdpt":
            path = PathConfig(w, w, spp, rr_depth=5, max_bounces=16,
                              bsdf_samples=1)
            means = {"bdpt": _means(chunk(BDPTConfig(
                         w, w, spp=spp, rr_depth=3, no_rr=False,
                         max_bounces=16))),
                     "path": _means(lambda key: render_chunk_path(
                         scene, cc, path, key, spp, samples_per_batch=spp))}
            pairs = [("bdpt", "path")]
        else:
            per_pixel = BDPTConfig(w, w, spp=4, rr_depth=3)
            pool = BDPTConfig(w, w, spp=4, rr_depth=3, light_pool=w * w)
            means = {"per_pixel": _means(chunk(per_pixel)),
                     "pool": [float(_pool_render(scene, cam, pool, seed)[0]
                                    .double().mean())
                              for seed in range(100, 106)]}
            pairs = [("per_pixel", "pool")]
        return means, pairs

    with _launched(*K12):
        means, pairs = estimate()
    for a, b in pairs:
        assert _z(means[a], means[b]) < 4.0, (a, b, means)


# case: (integrator, scene file lines, export settings, CLI arguments,
# the kernels it launches).
CLI_CASES = {
    "bdpt": ("bdpt", "", {}, ["--spp-chunk", "2"], K12),
    "path": ("path", "", dict(rr_depth=5), [], ("k1_closest_hit",)),
    "direct_mis": ("direct", 'samplingStrategy = "mis"\n', {}, [],
                   ("k1_closest_hit",)),
    "ao": ("ao", "", {}, [], K12),
    "realtime": ("ssao", "", dict(realtime=True), ["--frames", "2"], K12),
    "fly": ("simple", "", dict(realtime=True), ["--fly", "..w.."], K12),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_on_the_card(tmp_path, capsys, case):
    """The command-line renderer on its default device, the card, on a
    32x32 glass-box scene file, through the kernels alone: the EXR finite
    and not black, its meta.json naming the card and one device; bdpt
    with --checkpoint, then resumed from the finished checkpoint (no
    kernel launched, the same image); the realtime frame loop and the
    fly script."""
    import json

    from bpt_tpu_torch.cli import main as cli_main
    from bpt_tpu_torch.io.exr import read_exr
    from bpt_tpu_torch.scene.export import export_cornell_box

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    integrator, extra, kw, args, used = CLI_CASES[case]
    toml_path = export_cornell_box(
        str(tmp_path / case), width=32, height=32, spp=4,
        integrator=integrator, right_object="glass_sphere", sphere_subdiv=3,
        **kw)
    with open(toml_path, "a") as f:
        f.write(extra)
    if case == "bdpt":
        args = args + ["--checkpoint", str(tmp_path / "bdpt.ckpt")]
    out = str(tmp_path / f"{case}.exr")
    with _launched(*used):
        assert cli_main([toml_path, "--out", out, *args]) == 0
    img = read_exr(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["device"] == torch.cuda.get_device_name(0)
    assert meta["n_devices"] == 1
    if case in ("realtime", "fly"):
        assert meta["frames"] == (2 if case == "realtime" else 4)
    if case == "bdpt":
        capsys.readouterr()
        again = str(tmp_path / "again.exr")
        with _launched():
            assert cli_main([toml_path, "--out", again, *args]) == 0
        assert "resumed at 4/4 spp" in capsys.readouterr().out
        assert np.array_equal(read_exr(again), img)
