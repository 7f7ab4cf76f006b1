"""The gather backward kernel (csrc/gather_backward.cu, through
ops/gather.py::gather_rows_backward) on the card: equal to the plain
backward and to a float64 sum at the config #5 cell's shapes (1,048,576
and 3,145,728 lanes, 8 materials) and at more rows than one shared tile,
on edge inputs, bit-identical from call to call; one config #5 descent
step at 1024x1024 goes through it, never through the plain version, and
its trace holds no launch of autograd's indexing backward kernel.  These
need an NVIDIA GPU with nvcc and skip without one; run them on the card
with

    python -m pytest tests/test_torch_gather_cuda.py -q -m cuda --noconftest
"""
from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(n, m, n_tables, seed, id_dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, m, (n,), generator=gen, device=device)
    # The first half in runs of equal ids, as neighbouring pixels hit one
    # material; the rest scattered, as bounced rays do.
    ids[: n // 2] = ids[: n // 2].sort().values
    grads = [torch.randn((n, 3), generator=gen, device=device)
             for _ in range(n_tables)]
    return ids.to(id_dtype), grads


def _check(ids, grads, m):
    from bpt_tpu_torch.ops import gather

    launches = gather.gather_rows_backward.launches
    got = gather.gather_rows_backward(ids, grads, m)
    plain = gather.gather_rows_backward_plain(ids.long(), grads, m)
    torch.cuda.synchronize()
    # Two device kernels, the partial and the final sums; one without lanes.
    assert gather.gather_rows_backward.launches == launches + (
        2 if ids.numel() else 1)
    for g, p, grad in zip(got, plain, grads):
        exact = torch.zeros((m, 3), dtype=torch.float64, device=ids.device)
        exact.index_add_(0, ids.long(), grad.double())
        scale = torch.zeros_like(exact).index_add_(0, ids.long(),
                                                   grad.double().abs())
        # Float32 sums of up to 3M lanes: a tree's error is under
        # log2(N) ulps of the sum of |g|; 1e-5 of it leaves room.
        assert g.shape == (m, 3) and g.dtype == torch.float32
        assert torch.all((g.double() - exact).abs() <= 1e-5 * scale + 1e-30)
        assert torch.all((p.double() - exact).abs() <= 1e-5 * scale + 1e-30)
    return got


@pytest.mark.parametrize("n", [1_048_576, 3_145_728])
@pytest.mark.parametrize("n_tables", [1, 3])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_kernel_equals_plain_at_the_cell_shapes(cuda, n, n_tables, id_dtype):
    ids, grads = _inputs(n, 8, n_tables, n + n_tables, id_dtype, cuda)
    _check(ids, grads, 8)


@pytest.mark.parametrize("m", [65, 300])
def test_kernel_above_one_shared_tile(cuda, m):
    ids, grads = _inputs(1_048_576, m, 3, m, torch.int32, cuda)
    _check(ids, grads, m)


@pytest.mark.parametrize("n,m", [(0, 8), (1, 1), (1000, 1), (4099, 8),
                                 (31, 300)])
def test_kernel_on_edge_inputs(cuda, n, m):
    ids, grads = _inputs(n, m, 2, n + m, torch.int64, cuda)
    got = _check(ids, grads, m)
    if n == 0:
        assert all(torch.equal(g, torch.zeros_like(g)) for g in got)


def test_kernel_bit_identical_from_call_to_call(cuda):
    from bpt_tpu_torch.ops import gather

    ids, grads = _inputs(3_145_728, 8, 3, 17, torch.int32, cuda)
    first = gather.gather_rows_backward(ids, grads, 8)
    for _ in range(3):
        again = gather.gather_rows_backward(ids, grads, 8)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(first, again))


def test_descent_step_goes_through_the_kernel(cuda, monkeypatch):
    """One config #5 step (1024x1024, 2 spp) traced: the kernel launched,
    the plain version never, and no launch of autograd's
    indexing_backward kernel.  The step's backward calls, taken again on
    the inputs they had, give bit-identical sums.  (The forward's light
    splats add with atomics, so two whole steps may differ in the last
    bit of the loss.)"""
    from torch.profiler import ProfilerActivity, profile

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.diff import grad
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig
    from bpt_tpu_torch.ops import gather
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, cam = cornell_box_scene(1024, 1024, device="cuda",
                                      right_object="glass_sphere",
                                      sphere_subdiv=1)
    cfg = BDPTConfig(1024, 1024, spp=2, rr_depth=2, no_rr=True)
    cc = cam.device_constants("cuda")
    params = grad.extract_params(scene)
    with torch.no_grad():
        target = grad.render_with_params(params, scene, cc, cfg,
                                         rng.key(1, "cuda"), 2)
    start = {**params, "diffuse": params["diffuse"] * 0.7,
             "emission": params["emission"] * 0.4}
    calls = []
    inner = gather.gather_rows_backward

    def recorded(ids, grads, m):
        out = inner(ids, grads, m)
        if len(calls) < 8:
            calls.append((ids.clone(), [g.clone() for g in grads], m,
                          [o.clone() for o in out]))
        return out

    # The wrapper takes the wrapped function's name, so it holds the count.
    recorded.launches = launches = inner.launches
    monkeypatch.setattr(gather, "gather_rows_backward", recorded)
    plain = gather.gather_rows_backward_plain.cuda_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, g = grad.loss_and_grad(start, scene, cc, cfg, rng.key(2, "cuda"),
                                  2, target)
        torch.cuda.synchronize()
    assert gather.gather_rows_backward_plain.cuda_calls == plain
    assert recorded.launches > launches and calls
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not [k for k in names if "indexing_backward_kernel" in k]
    assert [k for k in names if "partial_sums" in k]
    assert g["diffuse"].abs().sum() > 0 and g["emission"].abs().sum() > 0
    for ids, grads, m, out in calls:
        again = inner(ids, grads, m)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(out, again))
