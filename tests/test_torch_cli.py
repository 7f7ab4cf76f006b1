"""The port's command-line renderer (`python -m bpt_tpu_torch.cli`) on the
CPU (`--device cpu`): the non-realtime tests of tests/test_cli.py on the
port, each integrator's EXR equal to the port's render function at the
same seed, and the refusal of a CUDA device that is not there.  The
realtime tests are in tests/test_torch_realtime.py."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bpt_tpu_torch.cli import main as cli_main
from bpt_tpu_torch.io.exr import read_exr
from bpt_tpu_torch.scene.export import export_cornell_box
from bpt_tpu_torch.scene.scene import load_scene
from bpt_tpu_torch.scene.toml_config import load_toml
from test_torch_bdpt import _one_thread  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _scene(tmp_path, name="scene", extra="", **kw):
    """A 16x16 box scene file (spp 2, rrDepth 2 unless `kw` says
    otherwise); `extra` lines go to the [renderer] table."""
    args = {"width": 16, "height": 16, "spp": 2, "rr_depth": 2, **kw}
    toml_path = export_cornell_box(str(tmp_path / name), **args)
    if extra:
        with open(toml_path, "a") as f:
            f.write(extra)
    return toml_path


def _meta(out):
    with open(out + ".meta.json") as f:
        return json.load(f)


def test_export_roundtrip(tmp_path):
    from bpt_tpu_torch.scene.procedural import cornell_box
    from bpt_tpu_torch.scene.scene import build_scene

    _scene(tmp_path)
    scene, meta = load_scene(str(tmp_path / "scene" / "cbox.obj"), "cpu")
    assert meta.n_emitters == 1 and meta.n_triangles > 10
    ref_scene, ref_meta = build_scene(cornell_box(), "cpu")
    assert meta.n_triangles == ref_meta.n_triangles
    np.testing.assert_allclose(scene.emitters.area.numpy(),
                               ref_scene.emitters.area.numpy(), rtol=1e-4)


def _render_function(toml_path, seed):
    """The image the port's render function gives the scene file's
    settings at `seed`, rounded to the EXR's half floats."""
    from bpt_tpu_torch.integrators import bdpt, direct, misc, path

    cfg_t = load_toml(toml_path)
    scene, meta = load_scene(cfg_t.obj_file, "cpu")
    w, h, spp = cfg_t.width, cfg_t.height, cfg_t.spp
    if cfg_t.integrator == "bdpt":
        img, _ = bdpt.render_image(scene, cfg_t.camera, bdpt.BDPTConfig(
            w, h, spp, rr_depth=cfg_t.rr_depth), seed=seed, spp_chunk=2)
    elif cfg_t.integrator == "path":
        img, _ = path.render_image_path(scene, cfg_t.camera, path.PathConfig(
            w, h, spp, rr_depth=cfg_t.rr_depth), seed=seed, spp_chunk=2)
    elif cfg_t.integrator == "direct":
        img, _ = direct.render_image_direct(
            scene, meta, cfg_t.camera, direct.DirectConfig(
                w, h, spp, strategy=cfg_t.sampling_strategy), seed=seed)
    else:
        img, _ = misc.render_image_misc(
            scene, meta, cfg_t.camera, misc.MiscConfig(
                w, h, spp, integrator=cfg_t.integrator), seed=seed)
    return img.numpy().astype(np.float16).astype(np.float32)


@pytest.mark.parametrize("integrator,extra", [
    ("bdpt", ""), ("path", ""), ("direct", 'samplingStrategy = "mis"\n'),
    ("normal", ""), ("simple", ""), ("ao", ""), ("ro", "")])
def test_cli_renders_exr(tmp_path, integrator, extra):
    toml_path = _scene(tmp_path, integrator, extra, integrator=integrator)
    out = str(tmp_path / f"{integrator}.exr")
    assert cli_main([toml_path, "--out", out, "--spp-chunk", "2",
                     "--seed", "5"] + CPU) == 0
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    if integrator != "normal":
        assert img.max() > 0.01
    np.testing.assert_array_equal(img, _render_function(toml_path, 5))
    meta = _meta(out)
    assert meta["device"] == "cpu" and meta["integrator"] == integrator
    assert meta["rays"] >= 16 * 16 * 2


def test_cli_direct_without_a_strategy_fails_as_the_reference(tmp_path):
    """load_toml gives a direct scene without samplingStrategy the
    strategy "emitter", which the integrator does not know (a fault of
    the reference, kept)."""
    toml_path = _scene(tmp_path, integrator="direct")
    with pytest.raises(ValueError, match="unknown strategy 'emitter'"):
        cli_main([toml_path, "--out", str(tmp_path / "d.exr")] + CPU)


def test_cli_writes_next_to_the_scene(tmp_path):
    toml_path = _scene(tmp_path, integrator="normal")
    assert cli_main([toml_path] + CPU) == 0
    assert os.path.exists(os.path.splitext(toml_path)[0] + ".exr")


def test_cli_checkpoint_resume(tmp_path):
    toml_path = _scene(tmp_path, spp=4)
    ck = str(tmp_path / "render.ckpt")
    out1 = str(tmp_path / "a.exr")
    assert cli_main([toml_path, "--out", out1, "--spp-chunk", "2",
                     "--checkpoint", ck] + CPU) == 0
    assert os.path.exists(ck)
    # Resuming a finished render does no extra work and writes the same
    # image.
    out2 = str(tmp_path / "b.exr")
    assert cli_main([toml_path, "--out", out2, "--spp-chunk", "2",
                     "--checkpoint", ck] + CPU) == 0
    np.testing.assert_array_equal(read_exr(out1), read_exr(out2))
    meta = _meta(out2)
    assert meta["spp"] == 4 and meta["width"] == 16


def test_cli_checkpoint_guards(tmp_path):
    """Resuming with another --seed must raise, not blend two sample
    streams."""
    from bpt_tpu_torch.io.checkpoint import CheckpointMismatch

    toml_path = _scene(tmp_path, spp=4)
    ck = str(tmp_path / "render.ckpt")
    out = str(tmp_path / "a.exr")
    assert cli_main([toml_path, "--out", out, "--spp-chunk", "2",
                     "--checkpoint", ck, "--seed", "1"] + CPU) == 0
    with pytest.raises(CheckpointMismatch):
        cli_main([toml_path, "--out", out, "--spp-chunk", "2",
                  "--checkpoint", ck, "--seed", "2"] + CPU)


def test_checkpoint_partial_resume_matches_straight_run(tmp_path,
                                                        monkeypatch):
    """A render interrupted after its first chunk and resumed gives the
    image of an uninterrupted run (sample keys depend on (pixel, sample)
    ids, not on chunking)."""
    from bpt_tpu_torch.io import checkpoint as ck_mod

    toml_path = _scene(tmp_path, spp=4)
    out1 = str(tmp_path / "straight.exr")
    assert cli_main([toml_path, "--out", out1, "--spp-chunk", "4",
                     "--seed", "3"] + CPU) == 0

    class Crash(Exception):
        pass

    ck = str(tmp_path / "part.ckpt")
    orig = ck_mod.save_checkpoint
    calls = {"n": 0}

    def crashing_save(*a, **kw):
        orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            raise Crash()

    monkeypatch.setattr(ck_mod, "save_checkpoint", crashing_save)
    with pytest.raises(Crash):
        cli_main([toml_path, "--out", str(tmp_path / "dead.exr"),
                  "--spp-chunk", "2", "--checkpoint", ck, "--seed", "3"]
                 + CPU)
    monkeypatch.setattr(ck_mod, "save_checkpoint", orig)

    out2 = str(tmp_path / "resumed.exr")
    assert cli_main([toml_path, "--out", out2, "--spp-chunk", "2",
                     "--checkpoint", ck, "--seed", "3"] + CPU) == 0
    np.testing.assert_allclose(read_exr(out1), read_exr(out2), atol=1e-6)


def test_cli_preview_writes_the_partial_estimate(tmp_path, monkeypatch):
    """--preview writes the EXR after every chunk but the last, scaled to
    the samples taken so far."""
    from bpt_tpu_torch.io import exr as exr_mod

    written = []
    orig = exr_mod.write_exr
    monkeypatch.setattr(exr_mod, "write_exr",
                        lambda p, img, **kw: (written.append(img.copy()),
                                              orig(p, img, **kw)))
    toml_path = _scene(tmp_path, spp=4)
    out = str(tmp_path / "p.exr")
    assert cli_main([toml_path, "--out", out, "--spp-chunk", "2",
                     "--preview"] + CPU) == 0
    assert len(written) == 2 and written[0].mean() > 0.0
    np.testing.assert_array_equal(read_exr(out),
                                  written[1].astype(np.float16))


def test_cli_bdpt_ablation_flags(tmp_path):
    """--mode / --rr / --samples-per-batch reach BDPTConfig."""
    toml_path = _scene(tmp_path)
    out_full = str(tmp_path / "full.exr")
    assert cli_main([toml_path, "--out", out_full] + CPU) == 0
    out_lt = str(tmp_path / "lt.exr")
    assert cli_main([toml_path, "--out", out_lt, "--mode", "light_trace",
                     "--samples-per-batch", "2"] + CPU) == 0
    meta = _meta(out_lt)
    assert meta["mode"] == "light_trace" and meta["no_rr"] is True
    # The ablation renders another estimator.
    assert not np.allclose(read_exr(out_full), read_exr(out_lt))
    out_rr = str(tmp_path / "rr.exr")
    assert cli_main([toml_path, "--out", out_rr, "--rr"] + CPU) == 0
    assert _meta(out_rr)["no_rr"] is False
    # RR walks deeper than the NO_RR hard bound: another image.
    assert not np.allclose(read_exr(out_full), read_exr(out_rr))


def test_toml_bdpt_ablation_keys(tmp_path):
    toml_path = _scene(tmp_path)
    with open(toml_path) as f:
        text = f.read()
    with open(toml_path, "w") as f:
        f.write(text.replace(
            'type = "bdpt"',
            'type = "bdpt"\nbdptMode = "path_trace"\nnoRR = false\n'
            'samplesPerBatch = 2'))
    cfg = load_toml(toml_path)
    assert cfg.bdpt_mode == "path_trace"
    assert cfg.no_rr is False
    assert cfg.samples_per_batch == 2


def test_cli_module_needs_a_gpu_or_the_cpu_flag(tmp_path):
    """`python -m bpt_tpu_torch.cli` without a CUDA device and without
    --device cpu raises before it renders; with --device cpu it renders."""
    toml_path = _scene(tmp_path, integrator="normal")
    out = str(tmp_path / "m.exr")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "bpt_tpu_torch.cli", toml_path, "--out",
            out]
    run = subprocess.run(base, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0
    assert "pass --device cpu" in run.stderr
    assert not os.path.exists(out)
    run = subprocess.run(base + CPU, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    assert "Saved EXR image to" in run.stdout
    assert read_exr(out).shape == (16, 16, 3)
