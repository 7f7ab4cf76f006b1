"""Procedural test scenes (port of bpt_tpu/scene/procedural.py).

A Cornell-box generator with the reference scenes' layout conventions
(camera at +z looking down -z, ceiling area light) and optional mirror /
glass content.  The ObjData builder is the reference package's, copied
because that module imports the JAX camera and scene assembler; only
`cornell_box_scene` differs, building the scene on a given device (the
card unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np

from ..core.camera import Camera
from .obj import Material, ObjData, Shape
from .scene import build_scene


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return [(a, b, c), (a, c, d)]


def _icosphere(center, radius, subdiv=2):
    """Icosphere vertices/faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = list(verts)
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key in cache:
            return cache[key]
        m = verts[i] + verts[j]
        m = m / np.linalg.norm(m)
        verts.append(m)
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for (i, j, k) in faces:
            a = midpoint(i, j)
            b = midpoint(j, k)
            c = midpoint(k, i)
            new_faces += [(i, a, c), (j, b, a), (k, c, b), (a, b, c)]
        faces = new_faces

    v = np.asarray(verts)
    normals = v.copy()
    v = v * radius + np.asarray(center)
    return v.astype(np.float32), normals.astype(np.float32), np.asarray(
        faces, np.int64
    )


def cornell_box(
    right_object: str = "none",
    left_object: str = "box",
    emission: float = 35.0,
    sphere_subdiv: int = 2,
):
    """Build a Cornell-box ObjData.

    right_object: 'none' | 'glass_sphere' | 'mirror_sphere' |
                  'diffuse_sphere' | 'mixture_sphere'
    left_object:  'none' | 'box' | 'mirror_box'
    """
    materials = [
        Material(name="floor", diffuse=np.array([0.725, 0.71, 0.68],
                 np.float32), illum=7),
        Material(name="ceiling", diffuse=np.array([0.725, 0.71, 0.68],
                 np.float32), illum=7),
        Material(name="backWall", diffuse=np.array([0.725, 0.71, 0.68],
                 np.float32), illum=7),
        Material(name="leftWall", diffuse=np.array([0.63, 0.065, 0.05],
                 np.float32), illum=7),
        Material(name="rightWall", diffuse=np.array([0.14, 0.45, 0.091],
                 np.float32), illum=7),
        Material(
            name="light",
            diffuse=np.array([0.78, 0.78, 0.78], np.float32),
            emission=np.full(3, emission, np.float32),
            illum=7,
        ),
    ]
    mat_idx = {m.name: i for i, m in enumerate(materials)}

    vertices: list = []
    shapes: list = []

    def add_shape(name, tris, mat_name, verts=None, normals=None,
                  nrm_idx=None):
        base = len(vertices)
        if verts is not None:
            vertices.extend(list(verts))
        v_idx = np.asarray(tris, np.int64) + base
        f = len(v_idx)
        if nrm_idx is None:
            n_idx = np.full((f, 3), -1, np.int64)
        else:
            n_idx = nrm_idx
        shapes.append(
            (name, v_idx, n_idx, np.full(f, mat_idx[mat_name], np.int64),
             normals)
        )

    # Box interior: x in [-1,1], y in [0,2], z in [-1,1]; opening at +z.
    p = {
        "flb": [-1.0, 0.0, 1.0], "frb": [1.0, 0.0, 1.0],
        "frt": [1.0, 0.0, -1.0], "flt": [-1.0, 0.0, -1.0],
        "clb": [-1.0, 2.0, 1.0], "crb": [1.0, 2.0, 1.0],
        "crt": [1.0, 2.0, -1.0], "clt": [-1.0, 2.0, -1.0],
    }
    q = {k: np.asarray(v, np.float32) for k, v in p.items()}

    def quad_shape(name, a, b, c, d, mat_name):
        verts = [q[a], q[b], q[c], q[d]]
        add_shape(name, _quad(0, 1, 2, 3), mat_name, verts=verts)

    quad_shape("floor", "flb", "frb", "frt", "flt", "floor")
    quad_shape("ceiling", "clt", "crt", "crb", "clb", "ceiling")
    quad_shape("backWall", "flt", "frt", "crt", "clt", "backWall")
    quad_shape("leftWall", "flb", "flt", "clt", "clb", "leftWall")
    quad_shape("rightWall", "frt", "frb", "crb", "crt", "rightWall")

    # Ceiling light (slightly below ceiling, facing down).
    ly = 1.98
    lv = [
        np.array([-0.25, ly, -0.25], np.float32),
        np.array([0.25, ly, -0.25], np.float32),
        np.array([0.25, ly, 0.25], np.float32),
        np.array([-0.25, ly, 0.25], np.float32),
    ]
    add_shape("light", _quad(0, 1, 2, 3), "light", verts=lv)

    if left_object in ("box", "mirror_box"):
        mat_name = "leftBox"
        materials.append(
            Material(
                name=mat_name,
                diffuse=np.array([0.725, 0.71, 0.68], np.float32),
                specular=np.array([0.5, 0.5, 0.5], np.float32),
                illum=7 if left_object == "box" else 3,
            )
        )
        mat_idx[mat_name] = len(materials) - 1
        # A tall box standing on the floor at the left.
        bmin = np.array([-0.65, 0.0, -0.55], np.float32)
        bmax = np.array([-0.05, 1.1, 0.05], np.float32)
        x0, y0, z0 = bmin
        x1, y1, z1 = bmax
        bv = [
            np.array(c, np.float32)
            for c in [
                (x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1),
                (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1),
            ]
        ]
        tris = (
            _quad(4, 5, 6, 7)      # top
            + _quad(0, 3, 2, 1)    # bottom
            + _quad(0, 1, 5, 4)    # back
            + _quad(2, 3, 7, 6)    # front
            + _quad(3, 0, 4, 7)    # left
            + _quad(1, 2, 6, 5)    # right
        )
        add_shape("leftBox", tris, mat_name, verts=bv)

    if right_object != "none":
        kind = {
            "glass_sphere": 6,
            "mirror_sphere": 3,
            "diffuse_sphere": 7,
            "mixture_sphere": 8,
        }[right_object]
        materials.append(
            Material(
                name="rightSphere",
                diffuse=np.array([1.0, 1.0, 1.0], np.float32),
                specular=np.array([1.0, 1.0, 1.0], np.float32),
                transmittance=np.array([1.0, 1.0, 1.0], np.float32),
                shininess=30.0,
                ior=1.5,
                illum=kind,
            )
        )
        mat_idx["rightSphere"] = len(materials) - 1
        sv, sn, sf = _icosphere([0.45, 0.45, 0.3], 0.45, sphere_subdiv)
        base_n = sf  # normal index == vertex index for the sphere
        add_shape("rightSphere", sf, "rightSphere", verts=sv,
                  normals=sn, nrm_idx=None)
        # Mark smooth normals for the sphere: replace the placeholder -1
        # indices with per-vertex normal indices appended to a normal pool.
        name, v_idx, n_idx, m_ids, normals = shapes[-1]
        shapes[-1] = (name, v_idx, base_n + 0, m_ids, (sn, sv))

    # Assemble ObjData.  Vertex normals: flat shapes get face normals via
    # n_idx = -1 handling in build_scene; the sphere provides smooth ones.
    all_normals: list = []
    fixed_shapes = []
    for (name, v_idx, n_idx, m_ids, extra) in shapes:
        if isinstance(extra, tuple):
            sn, _ = extra
            base = len(all_normals)
            all_normals.extend(list(sn))
            # sphere vertex i (local) -> normal index base + i; v_idx is
            # already offset by the global vertex base, so rebuild from the
            # local face list stored in n_idx.
            n_idx = n_idx + base
        else:
            n_idx = np.full_like(v_idx, -1)
        fixed_shapes.append(Shape(
            name=name,
            v_idx=v_idx,
            n_idx=n_idx,
            t_idx=np.full_like(v_idx, -1),
            mat_ids=m_ids,
        ))

    obj = ObjData(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        normals=np.asarray(all_normals, np.float32).reshape(-1, 3)
        if all_normals
        else np.zeros((0, 3), np.float32),
        texcoords=np.zeros((0, 2), np.float32),
        shapes=fixed_shapes,
        materials=materials,
    )
    return obj


def cornell_box_scene(width=64, height=64, device="cuda", **kwargs):
    """(SceneData, SceneMeta, Camera) for tests and benchmarks."""
    obj = cornell_box(**kwargs)
    scene, meta = build_scene(obj, device)
    cam = Camera.make(
        o=[0.0, 1.0, 3.8], at=[0.0, 1.0, 0.0], up=[0.0, 1.0, 0.0],
        fov=39.0, width=width, height=height,
    )
    return scene, meta, cam
