"""Wavefront OBJ/MTL parsing into numpy arrays (copy of
bpt_tpu/scene/obj.py, which the port must not import).

The same observable behaviour as the reference renderer's use of
tinyobjloader:
  * polygons are fan-triangulated (triangulate=true semantics);
  * one shape per `o`/`g` statement; per-face material ids from `usemtl`;
  * MTL fields parsed: Ns, Ka, Kd, Ks, Ke, Ni, d, Tf, illum, map_Kd.

Output is pure numpy; the scene assembler (scene/scene.py) turns it into
flat device tensors.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Material:
    name: str
    ambient: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    diffuse: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    specular: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    emission: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    transmittance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    shininess: float = 1.0
    ior: float = 1.0
    dissolve: float = 1.0
    illum: int = 0
    diffuse_texname: str = ""


@dataclasses.dataclass
class Shape:
    name: str
    # (F, 3) vertex / normal / texcoord indices per triangle (-1 = absent)
    v_idx: np.ndarray = None
    n_idx: np.ndarray = None
    t_idx: np.ndarray = None
    mat_ids: np.ndarray = None  # (F,)


@dataclasses.dataclass
class ObjData:
    vertices: np.ndarray    # (V, 3)
    normals: np.ndarray     # (VN, 3)
    texcoords: np.ndarray   # (VT, 2)
    shapes: List[Shape]
    materials: List[Material]


def load_mtl(path: str) -> List[Material]:
    materials: List[Material] = []
    cur: Optional[Material] = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = Material(name=parts[1] if len(parts) > 1 else "")
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ambient = np.array(parts[1:4], np.float32)
            elif key == "Kd":
                cur.diffuse = np.array(parts[1:4], np.float32)
            elif key == "Ks":
                cur.specular = np.array(parts[1:4], np.float32)
            elif key == "Ke":
                cur.emission = np.array(parts[1:4], np.float32)
            elif key == "Tf":
                cur.transmittance = np.array(parts[1:4], np.float32)
            elif key == "Ns":
                cur.shininess = float(parts[1])
            elif key == "Ni":
                cur.ior = float(parts[1])
            elif key == "d":
                cur.dissolve = float(parts[1])
            elif key == "illum":
                cur.illum = int(parts[1])
            elif key == "map_Kd":
                cur.diffuse_texname = parts[1]
    return materials


def _parse_face_vertex(token: str):
    """'v', 'v/t', 'v//n', 'v/t/n' -> (v, t, n) 0-based (-1 absent)."""
    comps = token.split("/")
    v = int(comps[0])
    t = int(comps[1]) if len(comps) > 1 and comps[1] else 0
    n = int(comps[2]) if len(comps) > 2 and comps[2] else 0
    return v, t, n


def load_obj(path: str) -> ObjData:
    vertices: List = []
    normals: List = []
    texcoords: List = []
    materials: List[Material] = []
    mat_index: Dict[str, int] = {}

    shapes: List[Shape] = []
    cur_name = ""
    cur_mat = -1
    faces_v: List = []
    faces_n: List = []
    faces_t: List = []
    faces_m: List = []

    def flush_shape(next_name):
        nonlocal faces_v, faces_n, faces_t, faces_m, cur_name
        if faces_v:
            shapes.append(
                Shape(
                    name=cur_name,
                    v_idx=np.asarray(faces_v, np.int64),
                    n_idx=np.asarray(faces_n, np.int64),
                    t_idx=np.asarray(faces_t, np.int64),
                    mat_ids=np.asarray(faces_m, np.int64),
                )
            )
            faces_v, faces_n, faces_t, faces_m = [], [], [], []
        cur_name = next_name

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                vertices.append([float(parts[1]), float(parts[2]),
                                 float(parts[3])])
            elif key == "vn":
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif key == "vt":
                texcoords.append([float(parts[1]), float(parts[2])])
            elif key == "f":
                fv = [_parse_face_vertex(tok) for tok in parts[1:]]

                def absolute(idx, count):
                    if idx > 0:
                        return idx - 1
                    if idx < 0:
                        return count + idx
                    return -1

                fv = [
                    (
                        absolute(v, len(vertices)),
                        absolute(t, len(texcoords)),
                        absolute(n, len(normals)),
                    )
                    for (v, t, n) in fv
                ]
                # Fan triangulation (tinyobj triangulate=true).
                for i in range(1, len(fv) - 1):
                    tri = (fv[0], fv[i], fv[i + 1])
                    faces_v.append([c[0] for c in tri])
                    faces_t.append([c[1] for c in tri])
                    faces_n.append([c[2] for c in tri])
                    faces_m.append(cur_mat)
            elif key in ("o", "g"):
                flush_shape(parts[1] if len(parts) > 1 else "")
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                cur_mat = mat_index.get(name, -1)
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, parts[1])
                materials = load_mtl(mtl_path)
                mat_index = {m.name: i for i, m in enumerate(materials)}
    flush_shape("")

    return ObjData(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, np.float32).reshape(-1, 2),
        shapes=shapes,
        materials=materials,
    )
