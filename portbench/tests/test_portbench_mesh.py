"""drivers/render_chunks_sharded.py, the four-card cell's job, on the
CPU at small.py's size, on a world of 2 ranks over gloo (this process is
rank 0): a sound run is correct; one rank's framebuffer left out of the
merge is not; a program without the progressive sharded entry fails
before any rank starts.  On a host of four cards (marker `cuda`, decided
inside the test) a short run of the cell is correct and reports its
metrics."""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from portbench import run as run_mod
from portbench.harness import common, packages
from portbench.tests.small import small_context

BENCH = common.benchmark()
CELL = next(w for w in BENCH["workloads"] if w["name"] == "caustic_bdpt_mesh4")
SEED = 2 ** 31 + 23


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _execute(trace=0, dp=2):
    ctx = small_context(CELL["name"], SEED, BENCH)
    ctx.config = {**ctx.config, "mesh": {**ctx.config["mesh"], "dp": dp}}
    run_mod.T_PROCESS = time.perf_counter()
    return run_mod.execute(BENCH, CELL, SEED, 0.5, trace, "cpu", ctx)


def test_world_of_two_is_correct():
    res = _execute()
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0 and res["nrays"] > 0
    assert res["compared"]["plain_calls_other_ranks"]["value"] == 0.0
    assert res["device"]["count"] == 4


def test_a_rank_left_out_of_the_merge_is_not_correct():
    pm = packages.module(packages.PROGRAM, "parallel.mesh")
    inner = pm._merge

    def without_rank0(fb, nrays, mesh, fb_mode):
        if mesh.dp_i == 0:
            fb = torch.zeros_like(fb)
        return inner(fb, nrays, mesh, fb_mode)

    with mock.patch.object(pm, "_merge", without_rank0):
        res = _execute()
    assert not res["correct"]
    assert res["compared"]["fb_gap"]["value"] > \
        res["compared"]["fb_gap"]["limit"]


def _children() -> set:
    pid = os.getpid()
    return {c for f in glob.glob(f"/proc/{pid}/task/*/children")
            for c in open(f).read().split()}


def test_a_program_without_the_progressive_entry_fails_at_once():
    """The entry as it was before it took sample_offset and
    samples_per_batch: RuntimeError within seconds, and no process left
    behind."""
    pm = packages.module(packages.PROGRAM, "parallel.mesh")

    def old(scene, cam_consts, cfg, mesh, key, spp_chunk, fb_mode="psum"):
        raise AssertionError("not to be called")

    before = _children()
    t0 = time.monotonic()
    with mock.patch.object(pm, "render_chunk_sharded", old):
        with pytest.raises(RuntimeError, match="sample_offset"):
            _execute()
    assert time.monotonic() - t0 < 30
    assert _children() <= before


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_four_cards(trace):
    if torch.cuda.device_count() < CELL["chips"]:
        pytest.skip(f"needs {CELL['chips']} CUDA cards")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL["name"],
         "--seed", str(SEED), "--seconds", "2", "--trace", str(trace)],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["count"] == 4
    if trace:
        assert res["metrics"]["graph_replay_pct.mesh"]["value"] == 100.0
        assert 0 < res["metrics"]["scaling_pct.mesh"]["value"] <= 105
        assert "merge_pct.mesh" in res["metrics"]
    else:
        assert {"rays_per_s", "setup_s"} <= set(res["metrics"])
