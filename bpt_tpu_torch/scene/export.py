"""Scene export: ObjData to OBJ/MTL plus a scene TOML (port of
bpt_tpu/scene/export.py).

`write_obj` and `write_scene_toml` are the reference module's own, which
imports os and the numpy OBJ records only.  `export_cornell_box` is
ported, because the reference's builds the box and the camera through
its JAX core; both write the same bytes.
"""
from __future__ import annotations

import os

from bpt_tpu.scene.export import write_obj, write_scene_toml

from ..core.camera import Camera
from .procedural import cornell_box

__all__ = ["export_cornell_box", "write_obj", "write_scene_toml"]


def export_cornell_box(out_dir: str, width: int = 64, height: int = 64,
                       spp: int = 16, integrator: str = "bdpt",
                       rr_depth: int = 3, realtime: bool = False,
                       **box_kwargs):
    """Materialise the procedural Cornell box as TOML+OBJ+MTL; returns the
    TOML path."""
    os.makedirs(out_dir, exist_ok=True)
    obj = cornell_box(**box_kwargs)
    obj_path = os.path.join(out_dir, "cbox.obj")
    write_obj(obj, obj_path)
    cam = Camera.make(o=[0.0, 1.0, 3.8], at=[0.0, 1.0, 0.0],
                      up=[0.0, 1.0, 0.0], fov=39.0, width=width,
                      height=height)
    toml_path = os.path.join(out_dir, "cbox.toml")
    write_scene_toml(toml_path, "cbox.obj", cam, spp=spp,
                     integrator=integrator, rr_depth=rr_depth,
                     realtime=realtime)
    return toml_path
