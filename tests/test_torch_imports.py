"""The port stands alone: no module of bpt_tpu_torch/ and nothing in
chip_smoke.py or probes/ imports jax or the JAX package bpt_tpu, directly
or through another module, and the port's copies of the reference's
numpy host modules (BVH builder, treelet cut, OBJ parser, free-fly
camera, Texture<T> classes) give arrays equal to the reference's."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from bpt_tpu.accel.build import build_bvh as ref_build_bvh
from bpt_tpu.accel.treelets import build_treelets as ref_build_treelets
from bpt_tpu.scene.obj import load_obj as ref_load_obj
from bpt_tpu_torch.accel.build import build_bvh
from bpt_tpu_torch.accel.treelets import build_treelets
from bpt_tpu_torch.scene.export import export_cornell_box
from bpt_tpu_torch.scene.obj import load_obj
from bpt_tpu_torch.scene.procedural import cornell_box
from bpt_tpu_torch.scene.scene import TREELET_K

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "bpt_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "probes").glob("*.py"))


def _imports_jax_package(path: Path, package: str = "bpt_tpu"):
    """(line, statement) of every import of `package` (bpt_tpu, not
    bpt_tpu_torch, by default) in the file."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name == package or name.startswith(package + "."):
                bad.append((node.lineno, name))
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package(path):
    assert _imports_jax_package(path) == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax(path):
    assert _imports_jax_package(path, "jax") == []


def test_guard_sees_an_import(tmp_path):
    """The AST check catches both import forms, nested ones included, and
    leaves the port's own name alone."""
    probe = tmp_path / "probe.py"
    probe.write_text("import bpt_tpu.scene\nfrom bpt_tpu.accel import build\n"
                     "import bpt_tpu_torch\nfrom bpt_tpu_torch.ops import x\n"
                     "def f():\n    import bpt_tpu\n")
    assert _imports_jax_package(probe) == [(1, "bpt_tpu.scene"),
                                           (2, "bpt_tpu.accel"),
                                           (6, "bpt_tpu")]
    probe.write_text("import jax\nfrom jax import numpy\nimport jaxlib\n"
                     "def f():\n    import jax.numpy as jnp\n")
    assert _imports_jax_package(probe, "jax") == [(1, "jax"), (2, "jax"),
                                                  (5, "jax.numpy")]


def test_scene_modules_load_without_the_jax_package():
    """Importing the scene entry points, the integrators, the CLI with
    its I/O, differentiation, the realtime loop, the device mesh, the
    native builder, chip_smoke.py and the inverse-rendering probe, in a
    fresh interpreter, loads no module of bpt_tpu and not jax."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, "probes")
        import bpt_tpu_torch.scene.scene
        import bpt_tpu_torch.scene.export
        import bpt_tpu_torch.scene.procedural
        import bpt_tpu_torch.integrators.path
        import bpt_tpu_torch.integrators.direct
        import bpt_tpu_torch.integrators.misc
        import bpt_tpu_torch.io.exr
        import bpt_tpu_torch.io.checkpoint
        import bpt_tpu_torch.cli
        import bpt_tpu_torch.diff.grad
        import bpt_tpu_torch.diff.inverse
        import bpt_tpu_torch.realtime
        import bpt_tpu_torch.core.flycam
        import bpt_tpu_torch.parallel.mesh
        import bpt_tpu_torch.native.native
        import chip_smoke
        import inverse_recover
        leaked = [m for m in sys.modules
                  if m in ("bpt_tpu", "jax") or m.startswith("bpt_tpu.")
                  or m.startswith("jax.")]
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def _triangles(obj):
    v_idx = np.concatenate([s.v_idx for s in obj.shapes], axis=0)
    return tuple(obj.vertices[v_idx[:, c]] for c in range(3))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The glass box at subdiv 5 (20,504 triangles) as built in memory,
    and the glass box at subdiv 3 exported to OBJ/MTL and read back by
    each package's parser."""
    tmp = tmp_path_factory.mktemp("obj")
    toml_path = export_cornell_box(str(tmp), right_object="glass_sphere",
                                   sphere_subdiv=3)
    obj_path = os.path.join(os.path.dirname(toml_path), "cbox.obj")
    return {"subdiv5": cornell_box(right_object="glass_sphere",
                                   sphere_subdiv=5),
            "exported_obj": load_obj(obj_path),
            "obj_path": obj_path}


def test_load_obj_matches_reference(sources):
    got, ref = load_obj(sources["obj_path"]), ref_load_obj(sources["obj_path"])
    for f in ("vertices", "normals", "texcoords"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert len(got.shapes) == len(ref.shapes) == 8
    for a, b in zip(got.shapes, ref.shapes):
        assert a.name == b.name
        for f in ("v_idx", "n_idx", "t_idx", "mat_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [vars(m).keys() for m in got.materials] == \
        [vars(m).keys() for m in ref.materials]
    for a, b in zip(got.materials, ref.materials):
        for k, v in vars(b).items():
            np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)


@pytest.mark.parametrize("name", ["subdiv5", "exported_obj"])
def test_bvh_and_treelets_match_reference(sources, name):
    v0, v1, v2 = _triangles(sources[name])
    got, ref = build_bvh(v0, v1, v2), ref_build_bvh(v0, v1, v2,
                                                    use_native=False)
    for f in ("bmin", "bmax", "miss", "start", "count", "prim_order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    perm = ref.prim_order
    v0r = v0[perm].astype(np.float32)
    e1 = (v1[perm] - v0[perm]).astype(np.float32)
    e2 = (v2[perm] - v0[perm]).astype(np.float32)
    tl = build_treelets(got, v0r, e1, e2, k=TREELET_K)
    tl_ref = ref_build_treelets(ref, v0r, e1, e2, k=TREELET_K)
    assert tl._fields == tl_ref._fields
    for f in tl._fields:
        np.testing.assert_array_equal(getattr(tl, f), getattr(tl_ref, f),
                                      err_msg=f)
    assert tl.bmin.shape[0] == {"subdiv5": 235, "exported_obj": 19}[name]


def test_flycam_matches_reference():
    """core/flycam.py's _rotate gives arrays equal to the reference's on
    random axes, angles and vectors, and parse_commands the same events."""
    from bpt_tpu.core import flycam as ref
    from bpt_tpu_torch.core import flycam

    rs = np.random.RandomState(8)
    for _ in range(50):
        axis, v = rs.normal(size=3), rs.normal(size=3)
        angle = rs.uniform(-np.pi, np.pi)
        np.testing.assert_array_equal(flycam._rotate(axis, angle, v),
                                      ref._rotate(axis, angle, v))
    script = "wasd.P+3.5;H-12;. w.P-90;..dd.H+0.25;."
    assert list(flycam.parse_commands(script)) == \
        list(ref.parse_commands(script))
    assert (flycam._SCALE, flycam._MAX_RATE, flycam._ANGLE_DAMP,
            flycam._DELTA_DAMP) == (ref._SCALE, ref._MAX_RATE,
                                    ref._ANGLE_DAMP, ref._DELTA_DAMP)


@pytest.mark.parametrize("cls", ["ConstantTexture3f", "ConstantTexture1f",
                                 "BitmapTexture3f", "BitmapTexture1f"])
def test_texture_classes_match_reference(cls):
    """Each Texture<T> class of the port returns what the reference's
    returns, by array equality, on a random 7x5 image (a constant for the
    constant textures) at random UVs inside and outside [0, 1)."""
    from bpt_tpu.scene import textures as ref
    from bpt_tpu_torch.scene import textures

    rs = np.random.RandomState(9)
    arg = {"ConstantTexture3f": rs.rand(3), "ConstantTexture1f": rs.rand(),
           "BitmapTexture3f": rs.rand(7, 5, 3).astype(np.float32),
           "BitmapTexture1f": rs.rand(7, 5, 3).astype(np.float32)}[cls]
    got, want = getattr(textures, cls)(arg), getattr(ref, cls)(arg)
    for st in rs.uniform(-2.0, 2.0, (40, 2)):
        np.testing.assert_array_equal(got.eval(st), want.eval(st))
    for method in ("average", "min", "max"):
        np.testing.assert_array_equal(getattr(got, method)(),
                                      getattr(want, method)())
