"""Host seconds the port spent in scene/scene.py::build_scene during
set-up (the timer setup.scene_build_s): flattening, the BVH and the
treelet table."""
from portbench.harness import spans


def read(reading):
    return spans.counter("setup.scene_build_s")
