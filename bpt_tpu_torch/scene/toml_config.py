"""TOML scene configuration (port of bpt_tpu/scene/toml_config.py).

Parses the reference renderer's scene.toml files unmodified (its
src/main.cpp:22-116): [input] objfile, [camera] eye/at/up/fov,
[film] width/height, [renderer] realtime/type + per-integrator settings,
with identical defaults.  The camera is the port's `Camera`; everything
else is the reference module's, field for field.
"""
from __future__ import annotations

import dataclasses
import os
import tomllib

from ..core.camera import Camera


@dataclasses.dataclass
class RenderConfig:
    toml_file: str
    obj_file: str
    camera: Camera
    width: int
    height: int
    spp: int
    integrator: str          # normal|simple|ao|ro|direct|path|bdpt
    realtime: bool = False
    # path (reference: main.cpp:94-102)
    is_explicit: bool = True
    max_depth: int = -1
    rr_depth: int = 5
    rr_prob: float = 0.95
    emitter_samples: int = 1
    bsdf_samples: int = 0
    # direct (main.cpp:88-93)
    sampling_strategy: str = "emitter"
    # ro (main.cpp:84-87)
    exponent: float = 30.0
    # bdpt ablations: the reference's compile-time LIGHT_TRACING /
    # PATH_TRACING / NO_RR switches (src/integrators/bdpt.h:16-18) as
    # runtime TOML keys (extensions over the reference schema).
    bdpt_mode: str = "bdpt"       # bdpt | light_trace | path_trace
    no_rr: bool = True            # reference ships NO_RR=1
    # samples fused per wavefront batch (extension)
    samples_per_batch: int = 1


def load_toml(path: str) -> RenderConfig:
    with open(path, "rb") as f:
        data = tomllib.load(f)

    inp = data.get("input", {})
    obj_file = inp.get("objfile", "")
    if not os.path.isabs(obj_file):
        obj_file = os.path.normpath(
            os.path.join(os.path.dirname(os.path.abspath(path)), obj_file)
        )

    cam_t = data.get("camera", {})
    film = data.get("film", {})
    width = int(film.get("width", 768))
    height = int(film.get("height", 576))
    camera = Camera.make(
        o=cam_t.get("eye", [1.0, 1.0, 0.0]),
        at=cam_t.get("at", [0.0, 0.0, 0.0]),
        up=cam_t.get("up", [0.0, 1.0, 0.0]),
        fov=float(cam_t.get("fov", 30.0)),
        width=width,
        height=height,
    )

    ren = data.get("renderer", {})
    typ = ren.get("type", "normal")
    cfg = RenderConfig(
        toml_file=os.path.abspath(path),
        obj_file=obj_file,
        camera=camera,
        width=width,
        height=height,
        spp=int(ren.get("spp", 1)),
        integrator=typ,
        realtime=bool(ren.get("realtime", False)),
    )
    if typ == "path":
        cfg.is_explicit = bool(ren.get("isExplicit", True))
        cfg.max_depth = int(ren.get("maxDepth", -1))
        cfg.rr_depth = int(ren.get("rrDepth", 5))
        cfg.rr_prob = float(ren.get("rrProb", 0.95))
        cfg.emitter_samples = int(ren.get("emitterSamples", 1))
        cfg.bsdf_samples = int(ren.get("bsdfSamples", 0))
    elif typ == "bdpt":
        # The reference stores bdpt settings in the pt slot
        # (main.cpp:103-107).
        cfg.rr_depth = int(ren.get("rrDepth", 5))
        cfg.rr_prob = float(ren.get("rrProb", 0.0))
        cfg.bdpt_mode = str(ren.get("bdptMode", "bdpt"))
        cfg.no_rr = bool(ren.get("noRR", True))
        cfg.samples_per_batch = int(ren.get("samplesPerBatch", 1))
        if cfg.bdpt_mode not in ("bdpt", "light_trace", "path_trace"):
            raise ValueError(
                f"bdptMode must be bdpt|light_trace|path_trace, got "
                f"{cfg.bdpt_mode!r}")
    elif typ == "direct":
        cfg.emitter_samples = int(ren.get("emitterSamples", 1))
        cfg.bsdf_samples = int(ren.get("bsdfSamples", 1))
        cfg.sampling_strategy = ren.get("samplingStrategy", "emitter")
    elif typ == "ro":
        cfg.exponent = float(ren.get("exponent", 30.0))
    return cfg
