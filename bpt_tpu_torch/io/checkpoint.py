"""Checkpoint / resume for progressive rendering; a copy of
bpt_tpu/io/checkpoint.py.

The reference saves the framebuffer once at the end and loses everything on
a crash (reference: src/core/integrator.cpp:22-30; SURVEY.md section 5).
Here renders accumulate in spp chunks and checkpoint (accumulation buffer +
RNG seed + spp-done count + a config hash) after every chunk, enabling
restart and progressive preview.

The config hash guards resume correctness: a checkpoint written for one
(scene, resolution, spp, integrator-config, seed) must not be silently
blended with samples from another — the estimator would mix two different
sample streams into one image (VERDICT r1 weak item 4).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, NamedTuple, Optional

import numpy as np


class Checkpoint(NamedTuple):
    fb: np.ndarray
    seed: int
    spp_done: int
    spp_total: int
    config_hash: str


class CheckpointMismatch(RuntimeError):
    """Resume attempted with a different seed or render configuration."""


def config_hash(**fields: Any) -> str:
    """Stable hash of the render configuration relevant to resume
    (scene identity, resolution, spp, integrator settings, seed)."""
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_checkpoint(path: str, fb: np.ndarray, seed: int, spp_done: int,
                    spp_total: int, cfg_hash: str = "") -> None:
    tmp = path + ".tmp"
    np.savez(tmp, fb=np.asarray(fb), seed=seed, spp_done=spp_done,
             spp_total=spp_total, config_hash=cfg_hash)
    # np.savez appends .npz when missing.
    src = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(src, path)


def load_checkpoint(path: str) -> Optional[Checkpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        ch = str(z["config_hash"]) if "config_hash" in z else ""
        return Checkpoint(z["fb"], int(z["seed"]), int(z["spp_done"]),
                          int(z["spp_total"]), ch)


def check_resume(ck: Checkpoint, seed: int, cfg_hash: str) -> None:
    """Raise CheckpointMismatch unless the checkpoint belongs to this
    exact render (same seed, same config hash)."""
    if ck.seed != seed:
        raise CheckpointMismatch(
            f"checkpoint was written with --seed {ck.seed}, resume "
            f"requested --seed {seed}; resuming would blend two sample "
            f"streams into one image. Re-run with --seed {ck.seed} or "
            f"delete the checkpoint.")
    if ck.config_hash and cfg_hash and ck.config_hash != cfg_hash:
        raise CheckpointMismatch(
            "checkpoint was written for a different render configuration "
            f"(hash {ck.config_hash} != {cfg_hash}); delete the checkpoint "
            "or restore the original scene/config.")
