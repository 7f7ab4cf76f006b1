"""The port's realtime front end on the CPU: the free-fly camera
(core/flycam.py: tests/test_flycam.py's checks, and its pose against the
reference's after a command script), the Texture<T> classes
(tests/test_textures.py's interface check), the frame loops of
realtime.py against the reference's (images through the aggregate gate
of tests/test_torch_bdpt.py::_gate, frame counts and pose resets equal)
and the command line's realtime branch (tests/test_cli.py's realtime
tests, with `--device cpu`)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bpt_tpu import realtime as jrt
from bpt_tpu.core import flycam as jfly
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu.scene.toml_config import RenderConfig as JRenderConfig
from bpt_tpu_torch import realtime as trt
from bpt_tpu_torch.cli import main as cli_main
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.core.flycam import FlyCamera, _rotate, parse_commands
from bpt_tpu_torch.io.exr import read_exr
from bpt_tpu_torch.scene import textures
from bpt_tpu_torch.scene.export import export_cornell_box
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays
from bpt_tpu_torch.scene.toml_config import RenderConfig, load_toml
from test_torch_bdpt import (  # noqa: F401  (_one_thread: a fixture)
    _gate, _one_thread)

W = 16
SCRIPT = "ww.P+5;.a H-2.5;.d.P-7;H+12;..s."


# ---- tests/test_flycam.py on the port ---------------------------------------

def _cam():
    return FlyCamera.from_lookat(o=(0.0, 0.0, 0.0), at=(0.0, 0.0, -1.0),
                                 up=(0.0, 1.0, 0.0), fov=45.0)


def test_move_scale_and_damping():
    c = _cam()
    c.move("w")                       # delta = dir * 0.5 (camera.h:115)
    assert c.update()
    np.testing.assert_allclose(c.position, [0, 0, -0.5], atol=1e-12)
    assert c.update()                 # delta damps by 0.8 (camera.h:68)
    np.testing.assert_allclose(c.position, [0, 0, -0.9], atol=1e-12)


def test_strafe_directions():
    c = _cam()
    c.move("d")                       # +cross(dir, up)
    c.update()
    assert c.position[0] != 0.0 and abs(c.position[1]) < 1e-12
    c2 = _cam()
    c2.move("a")
    c2.update()
    np.testing.assert_allclose(c2.position, -c.position, atol=1e-12)


def test_pitch_clamp_and_rotation():
    c = _cam()
    c.pitch(90.0)                     # clamped to 5 deg a call (camera.h:38)
    assert c._pitch == 5.0
    d0 = c.direction.copy()
    c.update()
    assert abs(np.linalg.norm(c.direction) - 1.0) < 1e-9
    ang = np.degrees(np.arccos(np.clip(np.dot(d0, c.direction), -1, 1)))
    np.testing.assert_allclose(ang, 5.0, atol=1e-6)
    c.update()                        # the damped 2.5 deg (camera.h:66)
    ang2 = np.degrees(np.arccos(np.clip(np.dot(d0, c.direction), -1, 1)))
    np.testing.assert_allclose(ang2, 7.5, atol=1e-6)


def test_combined_rotation_order_matches_reference():
    """Heading applies first, then pitch about the pre-rotation
    cross(dir, up) axis (camera.h:57); the other order differs."""
    c = _cam()
    d0 = c.direction.copy()
    up = c.up.copy()
    c.pitch(5.0)
    c.heading(4.0)
    c.update()
    expect = _rotate(np.cross(d0, up), np.radians(5.0),
                     _rotate(up, np.radians(4.0), d0))
    expect = expect / np.linalg.norm(expect)
    np.testing.assert_allclose(c.direction, expect, atol=1e-12)
    wrong = _rotate(up, np.radians(4.0),
                    _rotate(np.cross(d0, up), np.radians(5.0), d0))
    wrong = wrong / np.linalg.norm(wrong)
    assert not np.allclose(c.direction, wrong, atol=1e-9)


def test_heading_preserves_up_component():
    c = _cam()
    c.heading(4.0)
    c.update()
    assert abs(c.direction[1]) < 1e-12


def test_parse_commands():
    evs = list(parse_commands("ww.P+5;.a H-2.5;."))
    assert evs == [("w", 0.0), ("w", 0.0), (".", 0.0), ("P", 5.0),
                   (".", 0.0), ("a", 0.0), ("H", -2.5), (".", 0.0)]
    with pytest.raises(ValueError):
        list(parse_commands("x"))


def test_interactive_loop_resets_on_motion():
    w = h = 8
    scene, meta, cam = cornell_box_scene(w, h, device="cpu")
    cfg_t = RenderConfig(
        toml_file="<test>", obj_file="<proc>", camera=cam, width=w,
        height=h, spp=4, integrator="normal", realtime=True)
    writes = []
    img, poses = trt.run_interactive(
        scene, meta, cfg_t, "unused.exr", commands="..w..",
        write_exr=lambda path, im: writes.append(np.asarray(im).copy()))
    # Two frames at pose 0; the 'w' key then glides (the delta damps 0.8 a
    # frame), so every later frame is a new pose with accumulation reset.
    assert [n for n, _ in poses] == [2, 1, 1]
    assert len(writes) == 4
    assert torch.isfinite(img).all()
    assert not np.allclose(poses[0][1].o, poses[1][1].o)


def _drive(fly, commands):
    for ev, val in parse_commands(commands):
        if ev == ".":
            fly.update()
        elif ev in "wasd":
            fly.move(ev)
        else:
            (fly.pitch if ev == "P" else fly.heading)(val)


def test_fly_pose_matches_reference():
    """The port's FlyCamera and the reference's, driven by one command
    script from a scene camera, hold equal state, and their render
    cameras give equal constants."""
    start = dict(o=(0.0, 1.0, 3.8), at=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0),
                 fov=39.0)
    got, ref = FlyCamera.from_lookat(**start), jfly.FlyCamera.from_lookat(
        **start)
    _drive(got, SCRIPT)
    _drive(ref, SCRIPT)
    for f in ("position", "direction", "up", "fov", "_delta", "_pitch",
              "_heading"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    consts = got.camera(W, 12).host_constants()
    for k, v in ref.camera(W, 12).device_constants().items():
        np.testing.assert_array_equal(consts[k], np.asarray(v), err_msg=k)


# ---- tests/test_textures.py::test_texture_interface_parity on the port ------

def test_texture_interface_parity():
    c3 = textures.ConstantTexture3f([0.2, 0.4, 0.6])
    np.testing.assert_allclose(c3.eval(), [0.2, 0.4, 0.6])
    np.testing.assert_allclose(c3.average(), c3.min())
    c1 = textures.ConstantTexture1f(0.7)
    assert c1.eval() == c1.average() == c1.min() == c1.max() == 0.7

    rng = np.random.RandomState(2)
    img = rng.rand(4, 5, 3).astype(np.float32)
    b3 = textures.BitmapTexture3f(img)
    np.testing.assert_allclose(b3.average(), img.reshape(-1, 3).mean(0),
                               rtol=1e-6)
    np.testing.assert_allclose(b3.min(), img.reshape(-1, 3).min(0))
    np.testing.assert_allclose(b3.max(), img.reshape(-1, 3).max(0))
    np.testing.assert_allclose(b3.eval([0.5 / 5, 0.5 / 4]), img[0, 0])
    np.testing.assert_allclose(b3.eval([1.0 + 0.5 / 5, 0.5 / 4]),
                               img[0, 0])  # wrap
    np.testing.assert_allclose(b3.eval([-0.9, 0.6]), img[2, 0])

    b1 = textures.BitmapTexture1f(img)
    flat = img.reshape(-1)
    assert b1.eval([2.5 / 5, 1.5 / 4]) == flat[5 * 1 + 2]  # flat w*y+x
    assert b1.average() == pytest.approx(flat.mean(), rel=1e-6)
    assert b1.min() == flat[: flat.size // 3].min()
    assert b1.max() == flat[: flat.size // 3].max()


# ---- the frame loops against the reference's --------------------------------

@pytest.fixture(scope="module")
def pair():
    """Both packages' glass box from the reference's arrays, with each
    package's SceneMeta and camera: (js, jmeta, jc, ts, tmeta, tc)."""
    js, jmeta, jc = jax_cbox(W, W, right_object="glass_sphere",
                             sphere_subdiv=3)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    _, tmeta, _ = cornell_box_scene(W, W, device="cpu",
                                    right_object="glass_sphere",
                                    sphere_subdiv=3)
    tc = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    return js, jmeta, jc, ts, tmeta, tc


def _configs(pair, pass_type):
    _, _, jc, _, _, tc = pair
    kw = dict(toml_file="<test>", obj_file="<proc>", width=W, height=W,
              spp=4, integrator=pass_type, realtime=True, rr_depth=2)
    return JRenderConfig(camera=jc, **kw), RenderConfig(camera=tc, **kw)


@pytest.mark.parametrize("pass_type", ["normal", "simple", "ssao", "gi"])
def test_run_realtime_matches_reference(pair, pass_type):
    """Two frames of two jittered samples (unjittered rays through the
    diagonal pixels of a square image meet triangle edges, where the two
    packages' tracers may differ by a tie, ROADMAP.md queue 3)."""
    js, jmeta, _, ts, tmeta, _ = pair
    jcfg, tcfg = _configs(pair, pass_type)
    jw, tw = [], []
    ji, jf, jn = jrt.run_realtime(js, jmeta, jcfg, "unused.exr", seed=3,
                                  frames=2, spp_per_frame=2,
                                  write_exr=lambda p, im: jw.append(im))
    ti, tf, tn = trt.run_realtime(ts, tmeta, tcfg, "unused.exr", seed=3,
                                  frames=2, spp_per_frame=2,
                                  write_exr=lambda p, im: tw.append(im))
    assert tf == jf == 2 and len(tw) == len(jw) == 2
    assert ti.device.type == "cpu" and ti.shape == (W, W, 3)
    assert all(isinstance(im, np.ndarray) for im in tw)
    np.testing.assert_array_equal(tw[-1], ti.numpy())
    _gate(ti.numpy(), np.asarray(ji), tn, jn)
    _gate(tw[0], np.asarray(jw[0]), tn, jn)


def test_run_realtime_is_the_mean_of_its_frames(pair):
    """At one sample a frame (the command line's default) the running
    image is the mean of the pass's renders at seeds seed, seed + 1, ...,
    bit for bit, and each frame writes the running mean."""
    from bpt_tpu_torch.integrators.misc import MiscConfig, render_image_misc

    _, _, _, ts, tmeta, tc = pair
    _, tcfg = _configs(pair, "simple")
    writes = []
    img, frames, nrays = trt.run_realtime(
        ts, tmeta, tcfg, "unused.exr", seed=5,
        write_exr=lambda p, im: writes.append(im))
    assert frames == tcfg.spp and len(writes) == frames
    acc = torch.zeros((W, W, 3))
    total = 0
    for f in range(frames):
        frame, nr = render_image_misc(ts, tmeta, tc,
                                      MiscConfig(W, W, 1, "simple"),
                                      seed=5 + f)
        acc += frame
        total += nr
        np.testing.assert_array_equal(writes[f], (acc / (f + 1)).numpy())
    assert torch.equal(img, acc / frames) and nrays == total


def test_run_interactive_matches_reference(pair):
    js, jmeta, _, ts, tmeta, _ = pair
    jcfg, tcfg = _configs(pair, "simple")
    script = "..w..H+4;.P-3;.."
    ji, jposes = jrt.run_interactive(js, jmeta, jcfg, "unused.exr", script,
                                     seed=1, spp_per_frame=2,
                                     write_exr=lambda *a: None)
    ti, tposes = trt.run_interactive(ts, tmeta, tcfg, "unused.exr", script,
                                     seed=1, spp_per_frame=2,
                                     write_exr=lambda *a: None)
    assert [n for n, _ in tposes] == [n for n, _ in jposes] == \
        [2, 1, 1, 1, 1, 1]
    for (_, tcam_), (_, jcam_) in zip(tposes, jposes):
        for f in ("o", "at", "up"):
            np.testing.assert_array_equal(getattr(tcam_, f),
                                          np.asarray(getattr(jcam_, f)))
        assert tcam_.fov == jcam_.fov
    nrays = 2 * W * W
    _gate(ti.numpy(), np.asarray(ji), nrays, nrays)


# ---- tests/test_cli.py's realtime tests on the port -------------------------

CPU = ["--device", "cpu"]


def _rt_scene(tmp_path, integrator, **kw):
    args = {"width": 16, "height": 16, "spp": 4, "rr_depth": 2, **kw}
    return export_cornell_box(str(tmp_path / integrator),
                              integrator=integrator, realtime=True, **args)


@pytest.mark.parametrize("pass_type", ["gi", "ssao", "normal"])
def test_cli_realtime_progressive(tmp_path, pass_type):
    """A realtime = true scene runs the frame loop; the EXR holds the
    running image of run_realtime at the same seed."""
    toml_path = _rt_scene(tmp_path, pass_type)
    out = str(tmp_path / f"{pass_type}.exr")
    assert cli_main([toml_path, "--out", out, "--frames", "2",
                     "--seed", "4"] + CPU) == 0
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    cfg_t = load_toml(toml_path)
    from bpt_tpu_torch.scene.scene import load_scene

    scene, meta = load_scene(cfg_t.obj_file, "cpu")
    ref, _, _ = trt.run_realtime(scene, meta, cfg_t, "unused.exr", seed=4,
                                 frames=2, write_exr=lambda *a: None)
    np.testing.assert_array_equal(
        img, ref.numpy().astype(np.float16).astype(np.float32))


def test_cli_realtime_rejects_offline_integrator(tmp_path, capsys):
    toml_path = _rt_scene(tmp_path, "bdpt", spp=2)
    assert cli_main([toml_path, "--out", str(tmp_path / "x.exr"),
                     "--frames", "1"] + CPU) == 1
    assert "realtime mode supports" in capsys.readouterr().err


def test_cli_realtime_writes_meta(tmp_path):
    toml_path = _rt_scene(tmp_path, "normal", spp=2)
    out = str(tmp_path / "rt.exr")
    assert cli_main([toml_path, "--out", out, "--frames", "2"] + CPU) == 0
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["realtime"] is True and meta["frames"] == 2
    assert meta["rays"] > 0 and meta["device"] == "cpu"


def test_cli_fly(tmp_path):
    """--fly drives the free-fly camera: the meta counts the frames
    accumulated at each pose, the EXR is the last pose's image."""
    toml_path = _rt_scene(tmp_path, "simple")
    out = str(tmp_path / "fly.exr")
    assert cli_main([toml_path, "--out", out, "--fly", "..w.."] + CPU) == 0
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["realtime"] is True and meta["frames"] == 4
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and img.max() > 0.01
