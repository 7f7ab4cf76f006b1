"""The comparison that decides `correct` fails what it must: the control
(the reference in bfloat16 in the program's place) in every cell, and a
run of the harness, with the look for a card skipped, over a timed path
broken underneath (an answer altered where it is produced; for the
descent, a step that returns its state unchanged and half of the batch
left out).  A sound run of the same harness comes out correct."""
from __future__ import annotations

import contextlib
import time
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import run as run_mod
from portbench.harness import common, compare
from portbench.tests.small import cells, small_context

BENCH = common.benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _execute(name, seed=2 ** 31 + 5):
    run_mod.T_PROCESS = time.perf_counter()
    return run_mod.execute(BENCH, CELLS[name], seed, 0.5, 0, "cpu",
                           small_context(name, seed, BENCH))


@pytest.mark.parametrize("name", cells(BENCH))
def test_control_is_not_correct(name):
    ctx = small_context(name, 9, BENCH)
    cell = common.load_module("drivers", ctx.traffic["driver"]).Cell(ctx)
    ok, compared = compare.judge(cell.control(), ctx.limits)
    assert not ok, compared


@pytest.mark.parametrize("name", cells(BENCH))
def test_sound_run_is_correct(name):
    res = _execute(name)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert res["attempted"] >= 1 and res["failed"] == 0


def _altered_chunk(module, fn, what):
    inner = getattr(module, fn)

    def altered(*a, **k):
        fb, nr = inner(*a, **k)
        if what == "pixel":
            fb = fb.clone()
            fb[0] += 0.01 * fb.abs().mean() + 1e-6
        else:
            nr = nr + 1
        return fb, nr

    return mock.patch.object(module, fn, altered)


@pytest.mark.parametrize("what", ["pixel", "nrays"])
def test_altered_answer_is_not_correct(what):
    from portbench.harness import packages

    bdpt = packages.module(packages.PROGRAM, "integrators.bdpt")
    with _altered_chunk(bdpt, "render_chunk", what):
        res = _execute("caustic_bdpt")
    assert not res["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_descent_fault_is_not_correct(fault):
    inverse_steps = common.load_module("drivers", "inverse_steps")
    from portbench.harness import packages

    with inverse_steps.plant(packages.PROGRAM, fault):
        res = _execute("inverse_step")
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_descent_fault_in_the_reference_is_not_correct(fault):
    ctx = small_context("inverse_step", 4, BENCH)
    cell = common.load_module("drivers", "inverse_steps").Cell(ctx)
    ok, compared = compare.judge(cell.control(fault), ctx.limits)
    assert not ok, compared
    if fault == "state_unchanged":
        assert compared["update_gap"]["value"] == 1.0


def test_judge():
    ok, out = compare.judge({"a": 0.5, "b": 0.0}, {"a": 1.0, "b": 0})
    assert ok and list(out) == ["a", "b"]
    assert not compare.judge({"a": 2.0}, {"a": 1.0})[0]
    assert not compare.judge({}, {"a": 1.0})[0]
    assert not compare.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert compare.fb_gap(np.ones(4), np.ones(4)) == 0.0
    assert compare.fb_gap(np.ones(3), np.ones(4)) == float("inf")
    assert compare.norm_gaps({"x": np.zeros(3), "y": np.ones(3)},
                             {"x": np.ones(3), "y": np.ones(3)}) == 1.0
