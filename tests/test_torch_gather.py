"""The material-table gathers (bpt_tpu_torch/ops/gather.py) on the CPU:
`gather_rows`' forward bit-equal to `table[ids.long()]`, its backward
against autograd's own backward of the indexing (1e-6 relative) over row
counts, lane counts, table counts and tables without a gradient; every
gather site goes through it, and records no node without a gradient; a
whole render's loss bit-equal and its gradients equal with the sites'
former indexing; the span and the lane counter under a profiler."""
from __future__ import annotations

import contextlib
import sys
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bpt_tpu_torch import telemetry
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.diff import grad
from bpt_tpu_torch.integrators import bdpt, direct, misc, path
from bpt_tpu_torch.ops import gather
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from test_torch_bdpt import _one_thread  # noqa: F401  (a fixture)


def _inputs(m, n, n_tables, seed, id_dtype=torch.int64):
    gen = torch.Generator().manual_seed(seed)
    tables = [torch.rand((m, 3), generator=gen) for _ in range(n_tables)]
    ids = torch.randint(0, m, (n,), generator=gen).to(id_dtype)
    # Runs of equal ids, as neighbouring pixels hit one material.
    ids[: n // 2] = ids[: n // 2].sort().values
    return tables, ids


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_forward_bit_equal_to_indexing(id_dtype):
    tables, ids = _inputs(8, 1000, 3, seed=1, id_dtype=id_dtype)
    tables = [t.requires_grad_(True) for t in tables]
    got = gather.gather_rows(tuple(tables), ids)
    assert len(got) == 3
    for g, t in zip(got, tables):
        assert g.grad_fn is not None
        assert torch.equal(g, t.detach()[ids.long()])


@pytest.mark.parametrize("m", [1, 8, 300])
@pytest.mark.parametrize("n", [0, 1000, 4099])
@pytest.mark.parametrize("n_tables", [1, 3])
def test_backward_equals_autograd_indexing(m, n, n_tables):
    tables, ids = _inputs(m, n, n_tables, seed=m * 7 + n + n_tables)
    gen = torch.Generator().manual_seed(n + 3)
    weights = [torch.randn((n, 3), generator=gen) for _ in tables]

    def grads(gather_fn):
        leaves = [t.clone().requires_grad_(True) for t in tables]
        outs = gather_fn(leaves)
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        return torch.autograd.grad(loss, leaves)

    got = grads(lambda ls: gather.gather_rows(tuple(ls), ids))
    want = grads(lambda ls: [t[ids] for t in ls])
    for g, w in zip(got, want):
        assert g.shape == (m, 3)
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_backward_skips_a_table_without_grad():
    tables, ids = _inputs(8, 1000, 3, seed=5)
    leaves = [tables[0].requires_grad_(True), tables[1],
              tables[2].requires_grad_(True)]
    seen = []
    inner = gather.gather_rows_backward

    def recorded(ids_, grads_, m):
        seen.append(len(grads_))
        return inner(ids_, grads_, m)

    with mock.patch.object(gather, "gather_rows_backward", recorded):
        outs = gather.gather_rows(tuple(leaves), ids)
        g0, g2 = torch.autograd.grad(outs[0].sum() + 2 * outs[2].sum(),
                                     [leaves[0], leaves[2]])
    assert seen == [2]
    counts = torch.bincount(ids, minlength=8).float()[:, None].expand(8, 3)
    assert torch.equal(g0, counts)
    assert torch.equal(g2, 2 * counts)


def test_unused_output_takes_no_lanes():
    tables, ids = _inputs(8, 1000, 2, seed=6)
    leaves = [t.requires_grad_(True) for t in tables]
    with mock.patch.object(gather, "gather_rows_backward",
                           wraps=gather.gather_rows_backward) as bwd:
        outs = gather.gather_rows(tuple(leaves), ids)
        (g0,) = torch.autograd.grad(outs[0].sum(), [leaves[0]])
    assert bwd.call_count == 1
    assert len(bwd.call_args.args[1]) == 1
    assert torch.equal(g0[:, 0], torch.bincount(ids, minlength=8).float())


def test_gather_rows_records_a_node_only_with_a_gradient():
    tables, ids = _inputs(8, 100, 2, seed=7, id_dtype=torch.int32)
    leaves = tuple(t.requires_grad_(True) for t in tables)
    with torch.no_grad():
        outs = gather.gather_rows(leaves, ids)
    assert all(o.grad_fn is None for o in outs)
    outs = gather.gather_rows(tuple(t.detach() for t in tables), ids)
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
    outs = gather.gather_rows(leaves, ids)
    assert all(type(o.grad_fn).__name__ == "_GatherRowsBackward"
               for o in outs)


# ---- the gather sites ---------------------------------------------------

W = H = 8


@pytest.fixture(scope="module")
def box():
    scene, meta, cam = cornell_box_scene(W, H, device="cpu",
                                         right_object="glass_sphere")
    return scene, meta, cam


def _leaves(scene, requires_grad=True):
    return {f: p.detach().clone().requires_grad_(requires_grad)
            for f, p in grad.extract_params(scene).items()}


def _render(name, scene, meta, cam):
    """One render of an integrator family: its framebuffer."""
    cc = cam.device_constants("cpu")
    key = rng.key(4, "cpu")
    pix = torch.arange(W * H, dtype=torch.int32)
    if name == "bdpt":
        return bdpt.render_chunk(scene, cc, bdpt.BDPTConfig(W, H, spp=2,
                                                            rr_depth=3),
                                 key, 2)[0]
    if name == "path":
        return path.render_sample_path(
            scene, cc, path.PathConfig(W, H, spp=1, max_depth=3), key,
            pix)[0]
    if name == "direct":
        return direct.render_sample_direct(
            scene, direct.SphereLights(scene, meta), cc,
            direct.DirectConfig(W, H, spp=1), key, pix)[0]
    flp, fli = misc.first_light(scene, meta)
    return misc.render_sample_misc(
        scene, flp, fli, cc, misc.MiscConfig(W, H, spp=1,
                                             integrator="simple"),
        key, pix)[0]


INTEGRATORS = ["bdpt", "path", "direct", "misc"]


@pytest.mark.parametrize("name", INTEGRATORS)
@pytest.mark.parametrize("mode", ["no_grad", "tables_without_grad"])
def test_sites_build_no_gather_rows_node_without_a_gradient(box, mode, name):
    """The sites go through gather_rows, and without a gradient none of
    its outputs carries a node."""
    scene, meta, cam = box
    params = _leaves(scene, requires_grad=mode == "no_grad")
    scene = grad.apply_params(scene, params)
    outs = []
    apply = gather._GatherRows.apply

    def recorded(*args):
        out = apply(*args)
        outs.extend(out)
        return out

    with mock.patch.object(gather._GatherRows, "apply", recorded), \
            (torch.no_grad() if mode == "no_grad" else torch.enable_grad()):
        img = _render(name, scene, meta, cam)
    assert img.grad_fn is None
    assert outs and all(o.grad_fn is None for o in outs)


@pytest.mark.parametrize("name", INTEGRATORS)
def test_a_gradient_goes_through_gather_rows(box, name):
    scene, meta, cam = box
    scene = grad.apply_params(scene, _leaves(scene))
    img = _render(name, scene, meta, cam)
    with mock.patch.object(gather, "gather_rows_backward",
                           wraps=gather.gather_rows_backward) as bwd:
        img.sum().backward()
    assert bwd.call_count > 0


def _former_indexing(tables, ids):
    ids = ids.long()
    return tuple(t[ids] for t in tables)


@pytest.mark.parametrize("mode", ["bdpt", "light_trace"])
def test_render_gradient_equals_default_indexing(box, mode):
    """The same loss, bit for bit, and the same gradients as autograd's
    own backward of the sites' indexing."""
    scene, _, cam = box
    cfg = bdpt.BDPTConfig(W, H, spp=2, rr_depth=3, mode=mode)
    cc = cam.device_constants("cpu")
    with torch.no_grad():
        target = grad.render_with_params(grad.extract_params(scene), scene,
                                         cc, cfg, rng.key(1, "cpu"), 2)
    params = {f: p * 0.8 for f, p in grad.extract_params(scene).items()}
    args = (params, scene, cc, cfg, rng.key(2, "cpu"), 2, target)
    with mock.patch.object(gather, "gather_rows_backward",
                           wraps=gather.gather_rows_backward) as bwd:
        loss, got = grad.loss_and_grad(*args)
    assert bwd.call_count > 0
    with mock.patch.object(gather._GatherRows, "apply",
                           side_effect=AssertionError):
        loss_ref, want = _default_loss_and_grad(args)
    assert torch.equal(loss, loss_ref)
    for f in want:
        torch.testing.assert_close(got[f], want[f], rtol=1e-6, atol=1e-9)
    assert got["diffuse"].abs().sum() > 0


def _default_loss_and_grad(args):
    """loss_and_grad with every site's gather indexed as before: each
    module of the port that calls gather_rows gets `table[ids.long()]`."""
    real = gather.gather_rows
    with contextlib.ExitStack() as stack:
        for name, mod in list(sys.modules.items()):
            if (name.startswith("bpt_tpu_torch.")
                    and name != gather.__name__
                    and getattr(mod, "gather_rows", None) is real):
                stack.enter_context(mock.patch.object(mod, "gather_rows",
                                                      _former_indexing))
        return grad.loss_and_grad(*args)


def test_span_and_lane_counter_under_a_profiler(box):
    scene, _, cam = box
    cfg = bdpt.BDPTConfig(W, H, spp=2, rr_depth=3)
    cc = cam.device_constants("cpu")
    params = grad.extract_params(scene)
    target = torch.zeros((W * H, 3))
    lanes = []
    inner = gather.gather_rows_backward

    def recorded(ids, grads_, m):
        lanes.append(ids.shape[0])
        return inner(ids, grads_, m)

    telemetry.reset()
    with mock.patch.object(gather, "gather_rows_backward", recorded):
        grad.loss_and_grad(params, scene, cc, cfg, rng.key(3, "cpu"), 2,
                           target)
        assert "diff.gather.lanes" not in telemetry.snapshot()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            grad.loss_and_grad(params, scene, cc, cfg, rng.key(3, "cpu"), 2,
                               target)
    spans = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "bpt.diff.gather_bwd"]
    n_calls = len(lanes) // 2
    assert n_calls > 0 and len(spans) == n_calls
    assert telemetry.snapshot()["diff.gather.lanes"] == sum(lanes[n_calls:])
    telemetry.reset()
