"""parallel/mesh.py on torch.distributed: worlds of 2 and 4 CPU processes
over gloo, one per mesh shape, against the reference package's
single-device renders (tests/test_parallel.py's and tests/test_ring.py's
gates) and against the port's single-process gradient.

Each world is this file run as a script (`--worker`), one process a
rank, meeting through a FileStore under the test's temporary directory;
every rank runs every entry point of the mesh and writes what it got to
an .npz file, which the tests read.  The worlds start together, the
references are computed while they run, and a world still running after
WORLD_TIMEOUT_S is killed and its tests fail.  JAX is imported inside the
tests only: the workers import the port alone."""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
W = 16
SPP = 4
RR = 3
POOL = 32
POOL_SPP = 2
POOL_SEED = 11
WORLD_TIMEOUT_S = 120
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
FB_MODES = ("psum", "reduce_scatter")
# __graft_entry__.py::dryrun_multichip's training step: the glass box with
# a subdiv-1 sphere at 16x16, rr_depth 2, 4 spp, a zero target, key 0.
GRAD = dict(rr_depth=2, spp=4, lr=0.1)
# The ValueErrors each mesh must raise: (case, whether it applies).
ERRORS = ("mesh_size", "fb_mode", "pixels", "spp", "pool_zero", "pool_split")


# ---- the worker ------------------------------------------------------------

def _errors(pm, tb, scene, cc, cam, mesh, key):
    """{case: 1 if the call raised ValueError, else 0}."""
    n_dp, n_sp = mesh.n_dp, mesh.n_sp
    calls = {
        "mesh_size": lambda: pm.make_mesh(n_dp + 1, n_sp),
        "fb_mode": lambda: pm.render_chunk_sharded(
            scene, cc, tb.BDPTConfig(W, W, spp=1), mesh, key, 1, "bogus"),
        # 15 x 15 pixels do not split over 2 dp ranks.
        "pixels": lambda: pm.render_chunk_sharded(
            scene, cc, tb.BDPTConfig(15, 15, spp=1, rr_depth=2), mesh, key,
            0),
        "spp": lambda: pm.render_image_sharded(
            scene, cam, tb.BDPTConfig(W, W, spp=3, rr_depth=2), mesh),
        "pool_zero": lambda: pm.render_chunk_pool_ring(
            scene, cc, tb.BDPTConfig(W, W, spp=1, rr_depth=2), mesh, key, 0),
        "pool_split": lambda: pm.render_chunk_pool_ring(
            scene, cc, tb.BDPTConfig(W, W, spp=1, rr_depth=2, light_pool=3),
            mesh, key, 0),
    }
    out = {}
    for case, call in calls.items():
        try:
            call()
            out[case] = 0
        except ValueError:
            out[case] = 1
    return out


def _descent_step(mesh, device):
    """dryrun_multichip's sharded step: this rank renders its pixel and
    sample shards with autograd, the framebuffer is summed over the world
    (all_reduce of a detached copy), the loss is taken on the sum, the
    local gradient flows through this rank's part alone, and the
    gradients are summed over the world (all_reduce); then one SGD step.
    Returns (loss, {field: gradient}, {field: updated parameter})."""
    import torch.distributed as dist

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.diff.grad import apply_params, extract_params
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_sample
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, cam = cornell_box_scene(W, W, device=device,
                                      right_object="glass_sphere",
                                      sphere_subdiv=1)
    cfg = BDPTConfig(W, W, spp=GRAD["spp"], rr_depth=GRAD["rr_depth"])
    cc = cam.device_constants(device)
    params = extract_params(scene)
    leaves = {f: p.detach().requires_grad_(True) for f, p in params.items()}
    n_pix = W * W
    shard = n_pix // mesh.n_dp
    pix = torch.arange(mesh.dp_i * shard, (mesh.dp_i + 1) * shard,
                       dtype=torch.int32, device=device)
    chunk = cfg.spp // mesh.n_sp
    key = rng.key(0, device)
    with torch.enable_grad():
        s2 = apply_params(scene, leaves)
        fb = torch.zeros((n_pix, 3), device=device)
        for s in range(chunk):
            k = rng.fold_in(key, mesh.sp_i * chunk + s)
            fb = fb + render_sample(s2, cc, cfg, k, pix)[0]
        total = fb.detach().clone()
        dist.all_reduce(total)
        loss = torch.mean((fb + (total - fb.detach())) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    out = {}
    for (f, p), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p) if g is None else g.contiguous()
        dist.all_reduce(g)
        out[f] = g
    new = {f: (p - GRAD["lr"] * out[f]).detach() for f, p in leaves.items()}
    return loss.detach(), out, new


def worker(rank, world, n_dp, n_sp, store, out_path):
    import torch.distributed as dist

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators import bdpt as tb
    from bpt_tpu_torch.parallel import mesh as pm
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    torch.set_num_threads(1)
    device = pm.init_distributed(f"file://{store}", world, rank,
                                 backend="gloo")
    mesh = pm.make_mesh(n_dp, n_sp)
    assert (mesh.dp_i, mesh.sp_i) == divmod(rank, n_sp)
    scene, _, cam = cornell_box_scene(W, W, device=device)
    cc = cam.device_constants(device)
    res = {"dp_i": mesh.dp_i, "sp_i": mesh.sp_i}
    for mode in FB_MODES:
        for name, extra in (("bdpt", {}), ("light_trace",
                                           {"mode": "light_trace"})):
            cfg = tb.BDPTConfig(W, W, spp=SPP, rr_depth=RR, **extra)
            img, nr = pm.render_image_sharded(scene, cam, cfg, mesh, seed=0,
                                              fb_mode=mode)
            res[f"{name}_{mode}"] = img.numpy()
            res[f"{name}_{mode}_nrays"] = nr
        cfg = tb.BDPTConfig(W, W, spp=POOL_SPP, rr_depth=RR,
                            light_pool=POOL)
        fb, nr = pm.render_chunk_pool_ring(
            scene, cc, cfg, mesh, rng.key(POOL_SEED, device),
            POOL_SPP // n_sp, fb_mode=mode)
        res[f"ring_{mode}"] = fb.numpy()
        res[f"ring_{mode}_nrays"] = int(nr)
    for case, raised in _errors(pm, tb, scene, cc, cam, mesh,
                                rng.key(0, device)).items():
        res[f"error_{case}"] = raised
    loss, grads, new = _descent_step(mesh, device)
    res["grad_loss"] = loss.numpy()
    for f in grads:
        res[f"grad_{f}"] = grads[f].numpy()
        res[f"new_{f}"] = new[f].numpy()
    np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()


# ---- the tests --------------------------------------------------------------

def _start_world(tmp, name, n_dp, n_sp):
    world = n_dp * n_sp
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(r), str(world), str(n_dp), str(n_sp),
               str(tmp / f"{name}.store"), str(tmp / f"{name}.rank{r}.npz")]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _finish_world(procs, deadline):
    """(every rank exited 0, their output).  Ranks still running at the
    deadline are killed."""
    outs, ok = [], True
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += f"\nkilled after {WORLD_TIMEOUT_S} s"
        ok &= p.returncode == 0
        outs.append(out)
    return ok, "\n".join(o[-3000:] for o in outs)


def _references():
    """The reference package's single-device renders (default box, 16x16,
    seed 0: BDPT and light_trace at SPP; the pooled render of POOL_SPP
    samples at key POOL_SEED) and the port's single-process loss and
    gradient of dryrun_multichip's step."""
    import jax
    import jax.numpy as jnp

    from bpt_tpu.integrators import bdpt as jb
    from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.diff.grad import extract_params, loss_and_grad
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    js, _, jc = jax_cbox(W, W)
    ref = {}
    for name, extra in (("bdpt", {}), ("light_trace", {"mode": "light_trace"})):
        img, nr = jb.render_image(js, jc, jb.BDPTConfig(W, W, spp=SPP,
                                                        rr_depth=RR, **extra),
                                  seed=0, spp_chunk=SPP)
        ref[name] = (np.asarray(img), int(nr))
    cfg = jb.BDPTConfig(W, W, spp=POOL_SPP, rr_depth=RR, light_pool=POOL)
    cc = jc.device_constants()
    pix = jnp.arange(W * W, dtype=jnp.int32)
    pids = jnp.arange(POOL, dtype=jnp.int32)
    sample = jax.jit(lambda k: jb.render_sample_pool(js, cc, cfg, k, pix,
                                                     pids))
    fb, nrays = 0.0, 0
    for s in range(POOL_SPP):
        fb_s, nr = sample(jax.random.fold_in(jax.random.key(POOL_SEED), s))
        fb, nrays = fb + np.asarray(fb_s), nrays + int(nr)
    ref["ring"] = (fb, nrays)

    scene, _, cam = cornell_box_scene(W, W, device="cpu",
                                      right_object="glass_sphere",
                                      sphere_subdiv=1)
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig

    cfg = BDPTConfig(W, W, spp=GRAD["spp"], rr_depth=GRAD["rr_depth"])
    params = extract_params(scene)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, grads = loss_and_grad(params, scene, cam.device_constants("cpu"),
                                    cfg, rng.key(0, "cpu"), GRAD["spp"],
                                    torch.zeros((W * W, 3)))
    finally:
        torch.set_num_threads(n)
    ref["grad"] = (float(loss), {f: g.numpy() for f, g in grads.items()},
                   {f: p.numpy() for f, p in params.items()})
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks' results (or its failure), and the
    references."""
    from bpt_tpu_torch.native import native

    native.library()  # built once here, not by every rank at once
    tmp = tmp_path_factory.mktemp("worlds")
    started = {name: (_start_world(tmp, name, *shape), time.monotonic())
               for name, shape in MESHES.items()}
    ref = _references()
    worlds = {}
    for name, (procs, t0) in started.items():
        ok, log = _finish_world(procs, t0 + WORLD_TIMEOUT_S)
        ranks = ([dict(np.load(tmp / f"{name}.rank{r}.npz"))
                  for r in range(len(procs))] if ok else None)
        worlds[name] = (ranks, log)
    return worlds, ref


def _ranks(runs, name):
    ranks, log = runs[0][name]
    assert ranks is not None, f"world {name} failed:\n{log}"
    return ranks


def _full(rank, key, n_dp, mode, full_rows):
    """A rank's framebuffer rows and the reference rows they hold."""
    got = rank[key].reshape(-1, 3)
    if mode == "psum":
        return got, full_rows
    s = full_rows.shape[0] // n_dp
    return got, full_rows[int(rank["dp_i"]) * s:(int(rank["dp_i"]) + 1) * s]


@pytest.mark.parametrize("mode", FB_MODES)
@pytest.mark.parametrize("name", MESHES)
def test_sharded_image_matches_reference(runs, name, mode):
    """render_image_sharded on every rank: the reference's single-device
    render_image, rtol 1e-4 / atol 1e-5, equal ray counts (the gates of
    tests/test_parallel.py); reduce_scatter gathers the same image."""
    want, n_want = runs[1]["bdpt"]
    for rank in _ranks(runs, name):
        np.testing.assert_allclose(rank[f"bdpt_{mode}"], want, rtol=1e-4,
                                   atol=1e-5)
        assert int(rank[f"bdpt_{mode}_nrays"]) == n_want


@pytest.mark.parametrize("name", MESHES)
def test_light_trace_splats_are_conserved(runs, name):
    """Light-tracing splats land on any pixel of any shard; the merged
    image equals the single-device light_trace render in both merges."""
    want, n_want = runs[1]["light_trace"]
    assert want.sum() > 0.0
    for rank in _ranks(runs, name):
        for mode in FB_MODES:
            got = rank[f"light_trace_{mode}"]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-5)
            assert int(rank[f"light_trace_{mode}_nrays"]) == n_want


@pytest.mark.parametrize("mode", FB_MODES)
@pytest.mark.parametrize("name", MESHES)
def test_pool_ring_matches_reference(runs, name, mode):
    """render_chunk_pool_ring (the pool sharded over dp and rotated round
    the ring): the reference's single-device render_sample_pool,
    rtol 2e-4 / atol 2e-6 and equal ray counts (tests/test_ring.py's
    gates); under reduce_scatter each rank holds its pixel rows."""
    want, n_want = runs[1]["ring"]
    n_dp = MESHES[name][0]
    for rank in _ranks(runs, name):
        got, rows = _full(rank, f"ring_{mode}", n_dp, mode, want)
        np.testing.assert_allclose(got, rows, rtol=2e-4, atol=2e-6)
        assert int(rank[f"ring_{mode}_nrays"]) == n_want


@pytest.mark.parametrize("name", MESHES)
def test_mesh_refuses_what_it_cannot_split(runs, name):
    """ValueError for a mesh that does not cover the world, an unknown
    fb_mode, pixels or a pool that do not split over dp (where n_dp > 1),
    spp that does not split over sp (where n_sp > 1) and a ring without a
    pool."""
    n_dp, n_sp = MESHES[name]
    want = {"mesh_size": 1, "fb_mode": 1, "pixels": int(n_dp > 1),
            "spp": int(n_sp > 1), "pool_zero": 1,
            "pool_split": int(n_dp > 1)}
    for rank in _ranks(runs, name):
        assert {c: int(rank[f"error_{c}"]) for c in ERRORS} == want


@pytest.mark.parametrize("given", [dict(), dict(world_size=2),
                                   dict(rank=0)],
                         ids=["neither", "no_rank", "no_world_size"])
def test_init_method_without_rank_and_world_size_raises(tmp_path, given):
    """An explicit init_method needs the world size and the rank: a
    ValueError before any process group is joined, under NCCL too."""
    import torch.distributed as dist

    from bpt_tpu_torch.parallel.mesh import init_distributed

    with pytest.raises(ValueError, match="world size"):
        init_distributed(f"file://{tmp_path / 'store'}", **given)
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", MESHES)
def test_sharded_descent_step_matches_single_process(runs, name):
    """dryrun_multichip's step on the port (local gradients through each
    rank's shard, gradient all_reduce, one SGD step): the loss and every
    field's gradient of the single-process loss_and_grad, and the same
    update, on every rank."""
    loss, grads, params = runs[1]["grad"]
    for rank in _ranks(runs, name):
        np.testing.assert_allclose(float(rank["grad_loss"]), loss, rtol=1e-5)
        for f, g in grads.items():
            scale = max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(rank[f"grad_{f}"] / scale, g / scale,
                                       atol=1e-5, err_msg=f)
            np.testing.assert_allclose(rank[f"new_{f}"],
                                       params[f] - GRAD["lr"] * g,
                                       rtol=1e-5, atol=1e-7, err_msg=f)
        assert any(np.abs(g).max() > 0 for g in grads.values())


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    a = sys.argv[2:]
    worker(int(a[0]), int(a[1]), int(a[2]), int(a[3]), a[4], a[5])
