"""Inverse rendering: recover material parameters by pixel-gradient
descent (port of bpt_tpu/diff/inverse.py).

BASELINE.json config #5: "recover BSDF albedo + light emission via
pixel-gradient descent".  The optimizer renders the scene with the
current parameters, compares the render with a target image and descends
the detached-sampling gradient (diff/grad.py), on the scene's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..core import rng
from ..integrators.bdpt import BDPTConfig
from ..scene.scene import SceneData
from .grad import extract_params, loss_and_grad


@dataclasses.dataclass
class InverseResult:
    params: Dict[str, torch.Tensor]
    losses: list
    iterations: int


def recover_materials(
    scene: SceneData,
    camera,
    cfg: BDPTConfig,
    target_fb: torch.Tensor,
    *,
    fields=("diffuse", "emission"),
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    iterations: int = 50,
    lr: float = 0.5,
    spp_chunk: int = 2,
    seed: int = 0,
    callback: Optional[Callable] = None,
) -> InverseResult:
    """Adam-style (momentum + RMS) descent on the selected material fields,
    written out as the reference writes it (not torch.optim.Adam, whose
    order of operations differs).  Iteration `it` renders with the key
    fold_in(key(seed), it).

    target_fb: (W*H, 3) target framebuffer at full cfg.spp scale.
    Non-selected fields stay frozen at the scene's values.
    """
    device = scene.geom.v0.device
    cam_consts = camera.device_constants(device)
    params = extract_params(scene)
    if init_params:
        params.update(init_params)

    m = {f: torch.zeros_like(params[f]) for f in fields}
    v = {f: torch.zeros_like(params[f]) for f in fields}
    b1, b2, eps = 0.9, 0.999, 1e-8

    key = rng.key(seed, device)
    losses = []
    for it in range(iterations):
        k = rng.fold_in(key, it)
        loss, g = loss_and_grad(params, scene, cam_consts, cfg, k,
                                spp_chunk, target_fb)
        losses.append(float(loss))
        for f in fields:
            m[f] = b1 * m[f] + (1 - b1) * g[f]
            v[f] = b2 * v[f] + (1 - b2) * g[f] ** 2
            mh = m[f] / (1 - b1 ** (it + 1))
            vh = v[f] / (1 - b2 ** (it + 1))
            params[f] = torch.clamp_min(
                params[f] - lr * mh / (torch.sqrt(vh) + eps), 0.0)
        if callback:
            callback(it, float(loss), params)
    return InverseResult(params=params, losses=losses, iterations=iterations)
