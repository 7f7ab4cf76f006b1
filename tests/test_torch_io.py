"""The port's copies of the EXR writer/reader and the checkpoint module
(io/exr.py, io/checkpoint.py) against the reference package's: the same
bytes written for every compression and both pixel types, each file read
back by the other package, the same config hash, and the same resume
guards."""
from __future__ import annotations

import os

import numpy as np
import pytest

from bpt_tpu.io import checkpoint as jck
from bpt_tpu.io import exr as jexr
from bpt_tpu_torch.io import checkpoint as tck
from bpt_tpu_torch.io import exr as texr


def _image():
    img = np.random.RandomState(0).uniform(0, 4, (37, 53, 3)).astype(
        np.float32)
    img[0, :3] = [0.0, 65504.0, 1e-8]  # half-float range corners
    return img


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "float"])
def test_exr_bytes_match_reference(tmp_path, compression, half):
    img = _image()
    ours, ref = str(tmp_path / "port.exr"), str(tmp_path / "ref.exr")
    texr.write_exr(ours, img, half=half, compression=compression)
    jexr.write_exr(ref, img, half=half, compression=compression)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    back = texr.read_exr(ref)
    np.testing.assert_array_equal(back, jexr.read_exr(ours))
    if half:
        np.testing.assert_allclose(back, img.astype(np.float16), rtol=1e-3,
                                   atol=1e-3)
    else:
        np.testing.assert_array_equal(back, img)


def test_config_hash_matches_reference():
    fields = dict(scene="/scenes/cbox.obj", integrator="bdpt", width=16,
                  height=16, spp=4, rr_depth=2, rr_prob=0.0, seed=3,
                  mode="bdpt", no_rr=True)
    assert tck.config_hash(**fields) == jck.config_hash(**fields)
    assert tck.config_hash(**{**fields, "seed": 4}) != \
        tck.config_hash(**fields)


def test_checkpoint_round_trip_and_guards(tmp_path):
    fb = np.random.RandomState(1).rand(256, 3).astype(np.float32)
    path = str(tmp_path / "render.ckpt")
    assert tck.load_checkpoint(path) is None
    tck.save_checkpoint(path, fb, 3, 2, 4, "abc")
    assert os.listdir(tmp_path) == ["render.ckpt"]
    ours, ref = tck.load_checkpoint(path), jck.load_checkpoint(path)
    np.testing.assert_array_equal(ours.fb, fb)
    assert ours[1:] == ref[1:] == (3, 2, 4, "abc")
    tck.check_resume(ours, 3, "abc")
    with pytest.raises(tck.CheckpointMismatch, match="--seed 3"):
        tck.check_resume(ours, 4, "abc")
    with pytest.raises(tck.CheckpointMismatch, match="different render"):
        tck.check_resume(ours, 3, "xyz")
    # An older checkpoint without a hash resumes under any config.
    tck.check_resume(ours._replace(config_hash=""), 3, "xyz")
