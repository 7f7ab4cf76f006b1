"""Rendering over several devices: pixel shards x sample shards on
torch.distributed (port of bpt_tpu/parallel/mesh.py).

One process per device.  The reference's device mesh ('dp', 'sp')
becomes a grid of ranks, rank = dp_i * n_sp + sp_i (the order in which
its make_mesh reshapes the device list):

  * 'dp' shards the pixel lanes (and, in pooled mode, the light pool),
    'sp' the samples of a chunk;
  * every rank scatter-adds into its own full-image framebuffer (light
    splats land on any pixel), and one all_reduce over the world merges
    them, or a reduce_scatter over 'dp' and an all_reduce over 'sp'
    leave each rank its pixel shard;
  * RNG is keyed by (pixel, sample) and pool identity, so the sharded
    render equals the single-device one up to the order of float sums,
    for any mesh shape.

Ranks on CUDA use NCCL, one GPU each (torchrun --nproc_per_node=N);
CPU ranks use gloo.  Every collective is issued by every rank in the
same order.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core import rng
from ..integrators.bdpt import (
    BDPTConfig,
    LightVertexSlots,
    render_sample,
    render_sample_pool,
)

FB_MODES = ("psum", "reduce_scatter")


def init_distributed(init_method=None, world_size=None, rank=None,
                     backend="nccl"):
    """Join the process group: torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK) when no arguments are given,
    else `init_method` ("tcp://host:port" or "file://path") with the
    world size and this process's rank.  With NCCL the process is first
    bound to its local GPU (LOCAL_RANK, else rank modulo the GPUs on the
    host); CPU ranks pass backend="gloo".  Raises ValueError for an
    init_method without world_size and rank.  Returns this rank's
    device."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    elif rank is None or world_size is None:
        raise ValueError(f"init_method {init_method!r} needs the world size "
                         f"and this process's rank")
    device = torch.device("cpu")
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        local = rank % torch.cuda.device_count() if local is None \
            else int(local)
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return device


class Mesh(NamedTuple):
    """This rank's place in the (n_dp, n_sp) grid of ranks."""

    n_dp: int
    n_sp: int
    dp_i: int
    sp_i: int
    dp_group: object      # the ranks of this rank's sp_i, in dp order
    sp_group: object      # the ranks of this rank's dp_i, in sp order
    device: torch.device

    def rank_of(self, dp_i: int, sp_i: int) -> int:
        return dp_i * self.n_sp + sp_i


def make_mesh(n_dp: int = None, n_sp: int = 1) -> Mesh:
    """The ('dp', 'sp') grid over the process group's ranks; n_dp
    defaults to world size // n_sp.  Raises ValueError unless n_dp * n_sp
    is the world size.  Every rank creates every subgroup, in the same
    order (new_group is a collective)."""
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp < 1 or n_sp < 1 or n_dp * n_sp != world:
        raise ValueError(f"mesh {n_dp} x {n_sp} does not cover the world "
                         f"of {world} ranks")
    dp_i, sp_i = divmod(dist.get_rank(), n_sp)
    dp_groups = [dist.new_group([d * n_sp + s for d in range(n_dp)])
                 for s in range(n_sp)]
    sp_groups = [dist.new_group([d * n_sp + s for s in range(n_sp)])
                 for d in range(n_dp)]
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(n_dp, n_sp, dp_i, sp_i, dp_groups[sp_i], sp_groups[dp_i],
                device)


def _check(cfg: BDPTConfig, mesh: Mesh, fb_mode: str):
    if fb_mode not in FB_MODES:
        raise ValueError(f"unknown fb_mode {fb_mode!r}")
    n_pix = cfg.width * cfg.height
    if n_pix % mesh.n_dp:
        raise ValueError(f"pixel count {n_pix} must be divisible by the dp "
                         f"axis {mesh.n_dp}")


def _shard(n: int, mesh: Mesh, device):
    """This rank's contiguous block of arange(n) over 'dp'."""
    s = n // mesh.n_dp
    return torch.arange(mesh.dp_i * s, (mesh.dp_i + 1) * s,
                        dtype=torch.int32, device=device)


def _merge(fb, nrays, mesh: Mesh, fb_mode: str):
    """The collective that replaces the reference's per-pixel mutexes:
    every rank's buffer is a partial sum over the whole image."""
    if fb_mode == "psum":
        dist.all_reduce(fb)
    else:
        out = fb.new_empty((fb.shape[0] // mesh.n_dp, 3))
        dist.reduce_scatter_tensor(out, fb, group=mesh.dp_group)
        dist.all_reduce(out, group=mesh.sp_group)
        fb = out
    dist.all_reduce(nrays)
    return fb, nrays


def render_chunk_sharded(scene, cam_consts, cfg: BDPTConfig, mesh: Mesh,
                         key, spp_chunk: int, fb_mode: str = "psum"):
    """Render spp_chunk * n_sp samples a pixel over the mesh: this rank
    renders its 'dp' block of pixels for samples sp_i * spp_chunk + s,
    each keyed fold_in(key, sample), one render_sample a sample.

    Returns (framebuffer, nrays), summed over the world (weighted 1/spp a
    sample): fb_mode "psum" gives every rank the (W*H, 3) buffer (one
    all_reduce), "reduce_scatter" its (W*H / n_dp, 3) pixel rows (the
    memory-scalable merge).  nrays is a 0-dim int64 tensor."""
    _check(cfg, mesh, fb_mode)
    n_pix = cfg.width * cfg.height
    dev = scene.geom.v0.device
    pix = _shard(n_pix, mesh, dev)
    fb = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp_chunk):
        k = rng.fold_in(key, mesh.sp_i * spp_chunk + s)
        fb_s, nr = render_sample(scene, cam_consts, cfg, k, pix)
        fb = fb + fb_s
        nrays = nrays + nr
    return _merge(fb, nrays, mesh, fb_mode)


def _ring_rotate(mesh: Mesh):
    """rotate_fn of the pool ring: hand this rank's pool shard to
    (dp_i + 1, sp_i) and take the one of (dp_i - 1, sp_i), every field of
    LightVertexSlots in one batch of sends and receives (which cannot
    deadlock when the two peers are one rank, n_dp = 2)."""
    nxt = mesh.rank_of((mesh.dp_i + 1) % mesh.n_dp, mesh.sp_i)
    prv = mesh.rank_of((mesh.dp_i - 1) % mesh.n_dp, mesh.sp_i)

    def rotate(slots: LightVertexSlots) -> LightVertexSlots:
        recv = [torch.empty_like(a) for a in slots]
        ops = [dist.P2POp(dist.isend, a.contiguous(), nxt) for a in slots]
        ops += [dist.P2POp(dist.irecv, r, prv) for r in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return LightVertexSlots(*recv)

    return rotate


def render_chunk_pool_ring(scene, cam_consts, cfg: BDPTConfig, mesh: Mesh,
                           key, spp_chunk: int, fb_mode: str = "psum"):
    """Pooled light transport with the pool sharded over 'dp' as the
    pixels are, and the s>=2 connect run blockwise around a ring: each
    rank connects its eye vertices to the pool shard it holds, then hands
    the shard on to the next rank of its 'dp' group; after n_dp passes
    every eye shard has met every pool path, and no rank ever holds the
    whole pool.  Pool walks are keyed by global pool index, so the image
    equals the single-device render_sample_pool's up to float order.

    Samples and the merge as render_chunk_sharded.  Raises ValueError for
    cfg.light_pool <= 0 or a pool that does not divide by n_dp."""
    _check(cfg, mesh, fb_mode)
    if cfg.light_pool <= 0:
        raise ValueError("render_chunk_pool_ring needs cfg.light_pool > 0")
    if cfg.light_pool % mesh.n_dp:
        raise ValueError(f"light_pool {cfg.light_pool} must be divisible "
                         f"by the dp axis {mesh.n_dp}")
    n_pix = cfg.width * cfg.height
    dev = scene.geom.v0.device
    pix = _shard(n_pix, mesh, dev)
    pids = _shard(cfg.light_pool, mesh, dev)
    rotate = _ring_rotate(mesh) if mesh.n_dp > 1 else None
    fb = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp_chunk):
        k = rng.fold_in(key, mesh.sp_i * spp_chunk + s)
        fb_s, nr = render_sample_pool(scene, cam_consts, cfg, k, pix, pids,
                                      rotate_fn=rotate, n_ring=mesh.n_dp)
        fb = fb + fb_s
        nrays = nrays + nr
    return _merge(fb, nrays, mesh, fb_mode)


def render_image_sharded(scene, camera, cfg: BDPTConfig, mesh: Mesh,
                         seed: int = 0, fb_mode: str = "psum"):
    """The whole image over the mesh, cfg.spp split over 'sp'.  Returns
    the (H, W, 3) image and the int ray count on every rank; in
    "reduce_scatter" mode the pixel shards are gathered over 'dp' at the
    end.  Raises ValueError for spp that does not divide by n_sp."""
    if cfg.spp % mesh.n_sp:
        raise ValueError(f"spp {cfg.spp} must be divisible by the sp axis "
                         f"{mesh.n_sp}")
    dev = scene.geom.v0.device
    fb, nrays = render_chunk_sharded(
        scene, camera.device_constants(dev), cfg, mesh, rng.key(seed, dev),
        cfg.spp // mesh.n_sp, fb_mode)
    if fb_mode == "reduce_scatter":
        full = fb.new_empty((cfg.width * cfg.height, 3))
        dist.all_gather_into_tensor(full, fb, group=mesh.dp_group)
        fb = full
    return fb.reshape(cfg.height, cfg.width, 3), int(nrays)
