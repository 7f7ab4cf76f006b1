"""Shared integrator machinery: surface interactions and emitter
sampling (port of bpt_tpu/integrators/common.py).

Every function maps over a (B,) batch of lanes; terminated lanes are
masked, never removed, so shapes stay fixed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.api import Hit, trace_closest
from ..core import rng, warp
from ..core.math import barycentric, frame_to_local, make_frame, normalize
from ..ops.gather import gather_rows
from ..scene.textures import albedo_at


class Interaction(NamedTuple):
    """Batched surface interaction (reference: src/core/core.h:173-180).
    `wo` is local and points back along the incoming ray."""

    p: torch.Tensor         # (B, 3)
    t: torch.Tensor         # (B,)
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor       # (B,) BVH-order triangle id (clamped to >= 0)
    mat_id: torch.Tensor    # (B,)
    shape_id: torch.Tensor  # (B,)
    frame_ns: torch.Tensor  # (B, 3, 3) shading frame rows (s, t, n)
    ng: torch.Tensor        # (B, 3) geometric normal
    wo: torch.Tensor        # (B, 3) local outgoing direction
    valid: torch.Tensor     # (B,)


def make_interaction(scene, d, hit: Hit) -> Interaction:
    """Full surface interaction from a closest-hit record
    (reference: src/core/accel.h:125-172)."""
    tri = torch.clamp_min(hit.tri, 0)
    ti = tri.long()
    u, v = hit.u, hit.v
    p = scene.geom.v0[ti] + scene.geom.e1[ti] * u[:, None] + \
        scene.geom.e2[ti] * v[:, None]
    ns = normalize(barycentric(scene.n0[ti], scene.n1[ti], scene.n2[ti],
                               u, v))
    frame_ns = make_frame(ns)
    wo = frame_to_local(frame_ns, -d)
    return Interaction(
        p=p, t=hit.t, u=u, v=v, tri=tri,
        mat_id=scene.mat_id[ti], shape_id=scene.shape_id[ti],
        frame_ns=frame_ns, ng=scene.ng[ti], wo=wo, valid=hit.valid,
    )


class EmitterSample(NamedTuple):
    em_id: torch.Tensor       # (B,)
    select_pdf: torch.Tensor  # (B,) 1/numEmitters
    pos: torch.Tensor         # (B, 3)
    normal: torch.Tensor      # (B, 3) interpolated shading normal
    pos_pdf: torch.Tensor     # (B,) 1/emitter.area
    radiance: torch.Tensor    # (B, 3)


def select_emitter(scene, u):
    """Uniform emitter selection (reference: integrator.cpp:46-51)."""
    n = scene.emitters.radiance.shape[0]
    em_id = torch.clamp_max((u * n).to(torch.int32), n - 1)
    return em_id, torch.full_like(u, 1.0 / n)


def sample_emitter_position(scene, lkeys) -> EmitterSample:
    """selectEmitter + sampleEmitterPosition (reference:
    integrator.cpp:46-51, 73-100): face from the per-emitter area CDF,
    uniform-triangle warp, barycentric position + normal, pdf 1/area.
    `lkeys` is a (B, 2) lane key tensor."""
    u_sel = rng.uniform1(rng.lane_fold(lkeys, rng.EMITTER_SELECT))
    em_id, select_pdf = select_emitter(scene, u_sel)
    em = em_id.long()

    u_face = rng.uniform1(rng.lane_fold(lkeys, rng.EMITTER_FACE))
    cdf = scene.emitters.face_cdf[em]  # (B, F+1)
    # std::upper_bound(cdf, u) - 1, clamped (math.h:107-111).
    face = torch.sum(cdf <= u_face[:, None], dim=-1) - 1
    nf = scene.emitters.face_tri.shape[1]
    face = torch.clamp(face, 0, nf - 1)
    tri = scene.emitters.face_tri[em, face].long()

    uv = rng.uniform2(rng.lane_fold(lkeys, rng.EMITTER_POSITION))
    buv = warp.square_to_uniform_triangle(uv)
    bu, bv = buv[..., 0], buv[..., 1]

    pos = scene.geom.v0[tri] + scene.geom.e1[tri] * bu[:, None] + \
        scene.geom.e2[tri] * bv[:, None]
    n = normalize(barycentric(scene.n0[tri], scene.n1[tri], scene.n2[tri],
                              bu, bv))
    return EmitterSample(
        em_id=em_id,
        select_pdf=select_pdf,
        pos=pos,
        normal=n,
        pos_pdf=1.0 / scene.emitters.area[em],
        radiance=gather_rows((scene.emitters.radiance,), em)[0],
    )


def emission_at(scene, mat_id):
    """getEmission (reference: integrator.cpp:41-44)."""
    return gather_rows((scene.mat.emission,), mat_id)[0]


def textured_kd(scene, it: Interaction):
    """Per-lane textured diffuse at an interaction (None without
    textures)."""
    return albedo_at(scene, it.tri, it.u, it.v)


def primary_trace(scene, o, d, near, far):
    """Closest hit of the camera rays on (near, far) and its
    interaction."""
    hit = trace_closest(scene, o, d, near, far)
    return hit, make_interaction(scene, d, hit)


def sample_lane_keys(key, pixel_idx, sample_ids):
    """Lane keys of several samples batched together, pixel-major
    (p0s0, p0s1, ..., p1s0, ...): sample s of pixel p is keyed
    fold_in(fold_in(key, s), p), as one sample at a time would key it.
    Returns (pixel ids (S*P,), lane keys (S*P, 2))."""
    skeys = rng.fold_in(key[None, :], sample_ids)                 # (S, 2)
    lkeys = rng.fold_in(skeys[:, None, :], pixel_idx[None, :])    # (S, P, 2)
    n = sample_ids.shape[0] * pixel_idx.shape[0]
    return (pixel_idx.repeat_interleave(sample_ids.shape[0]),
            lkeys.transpose(0, 1).reshape(n, 2))
