"""The two implementations a driver can run: the program under test (the
port, `bpt_tpu_torch`) and the benchmark's plain reference.  Both have
the same module layout, so a driver names a module once and takes it
from either."""
from __future__ import annotations

import importlib

PROGRAM = "bpt_tpu_torch"
REFERENCE = "portbench.reference.bpt"


def module(pkg: str, name: str):
    """`name` (e.g. "integrators.bdpt") of package `pkg`."""
    return importlib.import_module(f"{pkg}.{name}")


def scene(pkg: str, config: dict, device):
    """(SceneData, SceneMeta, Camera) of the configuration, built on
    `device` from its parameters."""
    proc = module(pkg, "scene.procedural")
    return proc.cornell_box_scene(config["width"], config["height"],
                                  device=device, **config["scene"])
