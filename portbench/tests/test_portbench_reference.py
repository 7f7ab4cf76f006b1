"""The reference agrees with the port at a tiny size on the CPU, where
the port runs its plain versions: each cell's entry, bit for bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import common, packages
from portbench.tests.small import small_context


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_render_chunk_matches_the_port():
    ctx = small_context("caustic_bdpt", 2 ** 31 + 17)
    cell = common.load_module("drivers", ctx.traffic["driver"]).Cell(ctx)
    prog = cell._build(packages.PROGRAM)
    ref = cell._build(packages.REFERENCE)
    for off in (0, 6):
        a, na = cell._chunk(prog, off, cell.chunk_spp)
        b, nb = cell._chunk(ref, off, cell.chunk_spp)
        assert int(na) == int(nb) > 0
        assert torch.equal(a, b) and float(a.abs().sum()) > 0


def test_descent_matches_the_port():
    ctx = small_context("inverse_step", 3)
    cell = common.load_module("drivers", ctx.traffic["driver"]).Cell(ctx)
    got = cell._descend(packages.PROGRAM, lambda it: None, iterations=3)
    ref = cell.reference_record()
    assert got["losses"] == ref["losses"]
    for f in ("diffuse", "emission"):
        assert np.array_equal(got["grads"][0][f], ref["grads"][0][f])
        assert np.array_equal(got["params"][f], ref["params"][f])
    assert cell.compared(got, ref) == {"loss_gap": 0.0, "grad_gap": 0.0,
                                       "update_gap": 0.0}

