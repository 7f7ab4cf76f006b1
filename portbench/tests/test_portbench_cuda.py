"""run.py as a check runs it: without a card it fails and prints no
result; on the card (marker `cuda`, decided inside the test) a short
run of each cell is correct and reports its metrics.

    python -m pytest portbench/tests -q -m cuda -p no:cacheprovider
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import common

BENCH = common.benchmark()


def _run(cwd, cell, trace=0, seconds=2):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 11), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=cwd, capture_output=True, text=True, timeout=900)


def test_fails_without_a_card_or_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/ (no
    program), or on a machine without a card, the run fails."""
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", ".out",
                                                  "__pycache__"))
    out = _run(tmp_path, BENCH["workloads"][0]["name"])
    assert out.returncode != 0 and out.stdout.strip() == ""
    if not torch.cuda.is_available():
        out = _run(common.ROOT, BENCH["workloads"][0]["name"])
        assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = _run(common.ROOT, cell, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "compared"
    assert "setup_s" in res["metrics"] or trace
