"""Scene export: ObjData to OBJ/MTL plus a scene TOML (port of
bpt_tpu/scene/export.py).

Procedural scenes can be materialised on disk in the reference's scene
format, so the scene-file path (TOML -> OBJ/MTL -> render) runs without
external assets.  `write_obj` and `write_scene_toml` are copies of the
reference's; all three functions write the same bytes as the
reference's.
"""
from __future__ import annotations

import os

from ..core.camera import Camera
from .obj import ObjData
from .procedural import cornell_box


def write_obj(obj: ObjData, path: str) -> None:
    base = os.path.splitext(path)[0]
    mtl_path = base + ".mtl"
    mtl_name = os.path.basename(mtl_path)

    with open(mtl_path, "w") as f:
        f.write("# bpt_tpu material export\n")
        for m in obj.materials:
            f.write(f"newmtl {m.name}\n")
            f.write(f"Ns {m.shininess:.6f}\n")
            f.write("Ka {:.6f} {:.6f} {:.6f}\n".format(*m.ambient))
            f.write("Kd {:.6f} {:.6f} {:.6f}\n".format(*m.diffuse))
            f.write("Ks {:.6f} {:.6f} {:.6f}\n".format(*m.specular))
            f.write("Ke {:.6f} {:.6f} {:.6f}\n".format(*m.emission))
            if m.transmittance.any():
                f.write("Tf {:.6f} {:.6f} {:.6f}\n".format(
                    *m.transmittance))
            f.write(f"Ni {m.ior:.6f}\n")
            f.write(f"d {m.dissolve:.6f}\n")
            f.write(f"illum {m.illum}\n")
            if m.diffuse_texname:
                f.write(f"map_Kd {m.diffuse_texname}\n")
            f.write("\n")

    with open(path, "w") as f:
        f.write("# bpt_tpu scene export\n")
        f.write(f"mtllib {mtl_name}\n")
        for v in obj.vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for n in obj.normals:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for t in obj.texcoords:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for shape in obj.shapes:
            f.write(f"o {shape.name}\n")
            cur_mat = None
            for fi in range(len(shape.v_idx)):
                mid = int(shape.mat_ids[fi])
                if mid != cur_mat and 0 <= mid < len(obj.materials):
                    f.write(f"usemtl {obj.materials[mid].name}\n")
                    cur_mat = mid
                toks = []
                for c in range(3):
                    vi = shape.v_idx[fi, c] + 1
                    ti = shape.t_idx[fi, c] + 1 if shape.t_idx[fi, c] >= 0 \
                        else 0
                    ni = shape.n_idx[fi, c] + 1 if shape.n_idx[fi, c] >= 0 \
                        else 0
                    if ti and ni:
                        toks.append(f"{vi}/{ti}/{ni}")
                    elif ni:
                        toks.append(f"{vi}//{ni}")
                    elif ti:
                        toks.append(f"{vi}/{ti}")
                    else:
                        toks.append(f"{vi}")
                f.write("f " + " ".join(toks) + "\n")


def write_scene_toml(path: str, obj_file: str, camera, spp: int = 32,
                     integrator: str = "bdpt", rr_depth: int = 5,
                     realtime: bool = False, **extra) -> None:
    """Write a reference-schema scene TOML (main.cpp:22-116)."""
    with open(path, "w") as f:
        f.write("[input]\n")
        f.write(f'objfile = "{obj_file}"\n\n')
        f.write("[camera]\n")
        f.write(f"eye = [ {camera.o[0]}, {camera.o[1]}, {camera.o[2]} ]\n")
        f.write(f"at = [ {camera.at[0]}, {camera.at[1]}, {camera.at[2]} ]\n")
        f.write(f"up = [ {camera.up[0]}, {camera.up[1]}, {camera.up[2]} ]\n")
        f.write(f"fov = {camera.fov}\n\n")
        f.write("[film]\n")
        f.write(f"width = {camera.width}\n")
        f.write(f"height = {camera.height}\n\n")
        f.write("[renderer]\n")
        f.write(f"realtime = {'true' if realtime else 'false'}\n")
        f.write(f'type = "{integrator}"\n')
        f.write(f"rrDepth = {rr_depth}\n")
        f.write(f"spp = {spp}\n")
        for k, v in extra.items():
            if isinstance(v, bool):
                f.write(f"{k} = {'true' if v else 'false'}\n")
            elif isinstance(v, str):
                f.write(f'{k} = "{v}"\n')
            else:
                f.write(f"{k} = {v}\n")


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
