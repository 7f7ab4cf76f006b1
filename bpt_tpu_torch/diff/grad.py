"""Differentiable rendering: parameters, loss, gradients, FD checks (port
of bpt_tpu/diff/grad.py).

The estimator is differentiable end to end with respect to the material
parameters (albedo Kd, specular Ks, emission Ke, transmittance Tf) under
the detached-sampling convention of the reference: sampling decisions
(BSDF directions, their pdfs, Russian roulette, MIS weights) carry no
gradient (`.detach()` where the reference calls `stop_gradient`), and
parameter gradients flow through the contribution arithmetic only.  The
tracers take no tensor that requires grad and return none, so BVH
traversal, the trace kernels included, stays outside the autograd graph
and needs no backward.

Known limits of the detached estimator, as in the reference: no gradient
through the refraction direction with respect to IOR, and none through
the discrete reflect/refract choice.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..integrators.bdpt import BDPTConfig, render_chunk
from ..scene.scene import SceneData

# Material fields exposed as differentiable parameters.
PARAM_FIELDS = ("diffuse", "specular", "emission", "transmittance")


def extract_params(scene: SceneData) -> Dict[str, torch.Tensor]:
    return {f: getattr(scene.mat, f) for f in PARAM_FIELDS}


def apply_params(scene: SceneData, params: Dict[str, torch.Tensor]
                 ) -> SceneData:
    mat = scene.mat._replace(**params)
    # Rebind the emitter radiance to the (possibly updated) material
    # emission, so emission gradients flow through the light subpaths'
    # throughput and NEE, not only through the s=0 technique.
    emitters = scene.emitters._replace(
        radiance=mat.emission[scene.emitters.mat_id.long()])
    return scene._replace(mat=mat, emitters=emitters)


def render_with_params(params, scene: SceneData, cam_consts,
                       cfg: BDPTConfig, key, spp_chunk: int):
    """Differentiable forward render (one spp chunk)."""
    fb, _ = render_chunk(apply_params(scene, params), cam_consts, cfg, key,
                         spp_chunk)
    return fb


def image_loss(params, scene, cam_consts, cfg, key, spp_chunk, target_fb):
    fb = render_with_params(params, scene, cam_consts, cfg, key, spp_chunk)
    # Only spp_chunk of cfg.spp samples are rendered: rescale so the chunk
    # estimates the full-spp image.
    scale = cfg.spp / spp_chunk
    return torch.mean((fb * scale - target_fb) ** 2)


def loss_and_grad(params, scene, cam_consts, cfg: BDPTConfig, key,
                  spp_chunk, target_fb):
    """(loss, {field: gradient}) with torch autograd: a gradient for every
    entry of `params`, zeros where the entry does not reach the loss (as
    `jax.value_and_grad` returns them)."""
    leaves = {f: p.detach().requires_grad_(True) for f, p in params.items()}
    with torch.enable_grad():
        loss = image_loss(leaves, scene, cam_consts, cfg, key, spp_chunk,
                          target_fb)
    inputs = list(leaves.values())
    grads = (torch.autograd.grad(loss, inputs, allow_unused=True)
             if loss.requires_grad else [None] * len(inputs))
    return loss.detach(), {
        f: torch.zeros_like(p) if g is None else g
        for (f, p), g in zip(leaves.items(), grads)}


@torch.no_grad()
def finite_difference_check(params, scene, cam_consts, cfg, key, spp_chunk,
                            target_fb, field: str, index, eps: float = 1e-3):
    """Central finite difference of the loss with respect to one scalar
    parameter, with the SAME key (common random numbers), so the
    difference is exact for the detached estimator."""
    def loss_of(p):
        return image_loss(p, scene, cam_consts, cfg, key, spp_chunk,
                          target_fb)

    def bump(p, delta):
        arr = p[field].clone()
        arr[index] += delta
        return {**p, field: arr}

    f_plus = loss_of(bump(params, eps))
    f_minus = loss_of(bump(params, -eps))
    return (f_plus - f_minus) / (2 * eps)
