"""Scene assembly: OBJ/MTL data -> flat device tensors + BVH + treelets
(port of bpt_tpu/scene/scene.py).

The host side is the reference package's numpy pipeline, step for step,
on the port's copies of its host modules: triangles flattened across
shapes, a midpoint BVH (accel/build.py, the reference's numpy builder),
K = 128 treelets (accel/treelets.py::build_treelets), per-emitter face
CDFs.  Only the final conversion differs: the leaves become torch
tensors on a given device, with JAX's dtype canonicalisation (int64 ->
int32, float64 -> float32), so that every leaf equals the reference
package's exactly.

`scene_from_arrays` builds the same SceneData from numpy leaves keyed by
field path ("geom.v0", "treelets.block", ...), which is how a test hands
the reference package's arrays to the port.  `load_scene` reads an OBJ
file with scene/obj.py::load_obj, a copy of the reference's parser.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import telemetry
from ..accel.build import LEAF_SIZE, build_bvh
from ..accel.treelets import (TraceGeom, TreeletGeom, build_treelets,
                              make_treelet_geom)
from ..bsdf.bsdf import DIFFUSE, GLASS, MIRROR, MIXTURE, PHONG, MaterialTable
from .obj import ObjData, load_obj
from .textures import build_atlas, load_texture

TREELET_K = 128


class EmitterTable(NamedTuple):
    """Area emitters (E,) with padded per-face CDFs (leading 0, padded
    strictly above 1 so a search never lands on padding)."""

    radiance: torch.Tensor  # (E, 3)
    area: torch.Tensor      # (E,)
    shape_id: torch.Tensor  # (E,)
    mat_id: torch.Tensor    # (E,)
    face_cdf: torch.Tensor  # (E, Fmax + 1)
    face_tri: torch.Tensor  # (E, Fmax) BVH-order triangle index


class SceneData(NamedTuple):
    """Every device array the renderer reads.  Triangle arrays are in BVH
    order, padded by LEAF_SIZE degenerate triangles."""

    geom: TraceGeom
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    ng: torch.Tensor
    mat_id: torch.Tensor
    shape_id: torch.Tensor
    shape_emitter: torch.Tensor
    mat: MaterialTable
    emitters: EmitterTable
    treelets: TreeletGeom
    treelets_any: TreeletGeom
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_tex: torch.Tensor
    tex_atlas: torch.Tensor
    tex_size: torch.Tensor


@dataclasses.dataclass
class SceneMeta:
    """Host-side metadata that device code never touches."""

    n_triangles: int
    n_materials: int
    n_emitters: int
    n_shapes: int
    shape_names: List[str]
    shapes_center: np.ndarray
    shapes_aabb_min: np.ndarray
    shapes_aabb_max: np.ndarray
    material_names: List[str]
    bvh_nodes: int


_ILLUM_TO_KIND = {7: DIFFUSE, 3: MIRROR, 6: GLASS, 8: MIXTURE}

# Field -> record type, for rebuilding nested records from flat paths.
_RECORDS = {
    "geom": TraceGeom, "mat": MaterialTable, "emitters": EmitterTable,
    "treelets": TreeletGeom, "treelets_any": TreeletGeom,
}


def _canonical(a) -> np.ndarray:
    """JAX's default dtype canonicalisation of a host array."""
    a = np.asarray(a)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(_canonical(a), device=device)


def flatten_fields(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs of a nest of NamedTuples, in field order.  Works
    on either package's SceneData."""
    for name in tree._fields:
        leaf = getattr(tree, name)
        if hasattr(leaf, "_fields"):
            yield from flatten_fields(leaf, prefix + name + ".")
        else:
            yield prefix + name, leaf


def scene_from_arrays(arrays: Dict[str, np.ndarray], device) -> SceneData:
    """SceneData from numpy leaves keyed by field path (see
    `flatten_fields`)."""
    def build(cls, prefix):
        vals = {}
        for name in cls._fields:
            sub = _RECORDS.get(name) if cls is SceneData else None
            if sub is not None:
                vals[name] = build(sub, prefix + name + ".")
            else:
                vals[name] = _tensor(arrays[prefix + name], device)
        return cls(**vals)

    return build(SceneData, "")


def _material_table(obj: ObjData, device) -> MaterialTable:
    m = len(obj.materials)
    kind = np.full(m, PHONG, np.int32)
    diffuse = np.zeros((m, 3), np.float32)
    specular = np.zeros((m, 3), np.float32)
    emission = np.zeros((m, 3), np.float32)
    shininess = np.ones(m, np.float32)
    ior = np.ones(m, np.float32)
    transmittance = np.zeros((m, 3), np.float32)
    for i, mt in enumerate(obj.materials):
        kind[i] = _ILLUM_TO_KIND.get(mt.illum, PHONG)
        diffuse[i] = mt.diffuse
        specular[i] = mt.specular
        emission[i] = mt.emission
        shininess[i] = mt.shininess
        ior[i] = mt.ior
        transmittance[i] = mt.transmittance
    return MaterialTable(*(_tensor(a, device) for a in (
        kind, diffuse, specular, emission, shininess, ior, transmittance)))


@telemetry.timed("setup.scene_build_s")
def build_scene(obj: ObjData, device, tex_dir: str = ""
                ) -> tuple[SceneData, SceneMeta]:
    """Flatten an ObjData into (SceneData on `device`, SceneMeta)."""
    # --- flatten triangles across shapes (original order) -----------------
    v_idx = np.concatenate([s.v_idx for s in obj.shapes], axis=0)
    n_idx = np.concatenate([s.n_idx for s in obj.shapes], axis=0)
    t_idx = np.concatenate([s.t_idx for s in obj.shapes], axis=0)
    mat_id = np.concatenate([s.mat_ids for s in obj.shapes], axis=0)
    shape_id = np.concatenate(
        [np.full(len(s.v_idx), i, np.int64) for i, s in enumerate(obj.shapes)]
    )
    t = len(v_idx)

    v0 = obj.vertices[v_idx[:, 0]]
    v1 = obj.vertices[v_idx[:, 1]]
    v2 = obj.vertices[v_idx[:, 2]]
    gn = np.cross(v1 - v0, v2 - v0)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    if obj.normals.size > 0:
        # Per-corner shading normals, geometric normal where a face has no
        # normal index.
        nmax = len(obj.normals) - 1

        def corner(col):
            ok = col >= 0
            vals = obj.normals[np.clip(col, 0, nmax)]
            return np.where(ok[:, None], vals, gn)

        n0, n1, n2 = corner(n_idx[:, 0]), corner(n_idx[:, 1]), corner(
            n_idx[:, 2])
    else:
        n0 = n1 = n2 = gn

    # --- BVH (midpoint splits, the numpy builder) --------------------------
    bvh = build_bvh(v0, v1, v2)
    perm = bvh.prim_order  # new -> old
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(t, dtype=np.int32)

    v0r, v1r, v2r = v0[perm], v1[perm], v2[perm]
    n0r, n1r, n2r = n0[perm], n1[perm], n2[perm]
    mat_r = mat_id[perm].astype(np.int32)
    shape_r = shape_id[perm].astype(np.int32)

    if obj.texcoords.size > 0:
        tmax = len(obj.texcoords) - 1

        def tc(col):
            ok = col >= 0
            vals = obj.texcoords[np.clip(col, 0, tmax)]
            return np.where(ok[:, None], vals, 0.0).astype(np.float32)

        uv0 = tc(t_idx[:, 0])[perm]
        uv1 = tc(t_idx[:, 1])[perm]
        uv2 = tc(t_idx[:, 2])[perm]
    else:
        uv0 = uv1 = uv2 = np.zeros((t, 2), np.float32)

    # Diffuse bitmap textures (map_Kd), reference diffuse.h:23-26.
    images = []
    mat_tex = np.full(len(obj.materials), -1, np.int32)
    for i, mt in enumerate(obj.materials):
        if mt.diffuse_texname:
            path = mt.diffuse_texname
            if tex_dir and not os.path.isabs(path):
                path = os.path.join(tex_dir, path)
            img = load_texture(path)
            if img is not None:
                mat_tex[i] = len(images)
                images.append(img)
    atlas, tex_sizes = build_atlas(images)

    e1 = v1r - v0r
    e2 = v2r - v0r
    ng = np.cross(e1, e2)
    ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)

    # --- pad with degenerate triangles so leaf gathers stay in bounds ------
    pad3 = np.zeros((LEAF_SIZE, 3), np.float32)
    padi = np.zeros(LEAF_SIZE, np.int32)

    def padded(a, p):
        return np.concatenate([a.astype(p.dtype), p])

    tl = build_treelets(bvh, v0r.astype(np.float32),
                        e1.astype(np.float32), e2.astype(np.float32),
                        k=TREELET_K)
    treelets = make_treelet_geom(tl, device)

    def dev(a):
        return _tensor(a, device)

    geom = TraceGeom(
        v0=dev(np.concatenate([v0r, pad3]).astype(np.float32)),
        e1=dev(np.concatenate([e1, pad3]).astype(np.float32)),
        e2=dev(np.concatenate([e2, pad3]).astype(np.float32)),
        node_bmin=dev(bvh.bmin), node_bmax=dev(bvh.bmax),
        node_miss=dev(bvh.miss), node_start=dev(bvh.start),
        node_count=dev(bvh.count),
    )

    # --- emitters (first face's material decides; renderer.cpp:281-289) ---
    em_shapes = []
    for i, s in enumerate(obj.shapes):
        first_mat = int(s.mat_ids[0])
        if first_mat >= 0:
            ke = obj.materials[first_mat].emission
            if float(np.dot(ke, ke)) > 0.0:
                em_shapes.append((i, ke, first_mat))

    e = len(em_shapes)
    fmax = 1
    per_emitter = []
    for i, ke, first_mat in em_shapes:
        tri_sel = np.nonzero(shape_id == i)[0]  # original order
        va, vb, vc = v0[tri_sel], v1[tri_sel], v2[tri_sel]
        cr = np.cross(vb - va, vc - va)
        areas = 0.5 * np.sqrt(np.sum(cr * cr, axis=-1))
        total = float(areas.sum())
        cdf = np.concatenate([[0.0], np.cumsum(areas)]) / max(total, 1e-30)
        per_emitter.append((i, ke, first_mat, total, cdf,
                            inv_perm[tri_sel]))
        fmax = max(fmax, len(tri_sel))

    em_radiance = np.zeros((max(e, 1), 3), np.float32)
    em_area = np.ones(max(e, 1), np.float32)
    em_shape = np.full(max(e, 1), -1, np.int32)
    em_mat = np.zeros(max(e, 1), np.int32)
    em_cdf = np.ones((max(e, 1), fmax + 1), np.float32)
    em_tri = np.zeros((max(e, 1), fmax), np.int32)
    shape_emitter = np.full(len(obj.shapes), -1, np.int32)
    for eid, (sid, ke, mid, total, cdf, tris) in enumerate(per_emitter):
        em_radiance[eid] = ke
        em_area[eid] = total
        em_shape[eid] = sid
        em_mat[eid] = mid
        em_cdf[eid, : len(cdf)] = cdf
        em_cdf[eid, len(cdf):] = 1.0 + 1e-6  # padding strictly above 1
        em_tri[eid, : len(tris)] = tris
        shape_emitter[sid] = eid

    emitters = EmitterTable(*(dev(a) for a in (
        em_radiance, em_area, em_shape, em_mat, em_cdf, em_tri)))

    scene = SceneData(
        geom=geom,
        n0=dev(np.concatenate([n0r, pad3]).astype(np.float32)),
        n1=dev(np.concatenate([n1r, pad3]).astype(np.float32)),
        n2=dev(np.concatenate([n2r, pad3]).astype(np.float32)),
        ng=dev(np.concatenate([ng, pad3]).astype(np.float32)),
        mat_id=dev(padded(mat_r, padi)),
        shape_id=dev(padded(shape_r, padi)),
        shape_emitter=dev(shape_emitter),
        mat=_material_table(obj, device),
        emitters=emitters,
        treelets=treelets,
        treelets_any=treelets,
        uv0=dev(np.concatenate([uv0, pad3[:, :2]])),
        uv1=dev(np.concatenate([uv1, pad3[:, :2]])),
        uv2=dev(np.concatenate([uv2, pad3[:, :2]])),
        mat_tex=dev(mat_tex),
        tex_atlas=dev(atlas),
        tex_size=dev(tex_sizes),
    )

    # --- host metadata -----------------------------------------------------
    centers = np.zeros((len(obj.shapes), 3), np.float32)
    ab_min = np.full((len(obj.shapes), 3), np.inf, np.float32)
    ab_max = np.full((len(obj.shapes), 3), -np.inf, np.float32)
    for i, s in enumerate(obj.shapes):
        # Averaged over all face-vertex references, repeats included
        # (renderer.cpp:295-304).
        pts = obj.vertices[s.v_idx.reshape(-1)]
        centers[i] = pts.mean(axis=0)
        ab_min[i] = pts.min(axis=0)
        ab_max[i] = pts.max(axis=0)

    meta = SceneMeta(
        n_triangles=t,
        n_materials=len(obj.materials),
        n_emitters=e,
        n_shapes=len(obj.shapes),
        shape_names=[s.name for s in obj.shapes],
        shapes_center=centers,
        shapes_aabb_min=ab_min,
        shapes_aabb_max=ab_max,
        material_names=[m.name for m in obj.materials],
        bvh_nodes=bvh.n_nodes,
    )
    return scene, meta


def load_scene(obj_path: str, device) -> tuple[SceneData, SceneMeta]:
    """Scene of an OBJ/MTL file on `device`; map_Kd textures resolve
    relative to the file's directory."""
    return build_scene(load_obj(obj_path), device,
                       tex_dir=os.path.dirname(os.path.abspath(obj_path)))
