"""spread.py reads runs as a check does: the spread is the quartile
distance (statistics.quantiles, n=4) over the median, and a run's unit
walls come from the line run.py logs."""
from __future__ import annotations

import json

import pytest

from portbench import spread


def test_spread_and_trimmed_spread():
    values = [1.0, 1.1, 0.9, 1.2, 1.0, 3.0]
    q1, med, q3 = 0.975, 1.05, 1.65
    assert spread.spread(values) == pytest.approx((q3 - q1) / med)
    assert spread.trimmed_spread(values) == pytest.approx(
        spread.spread(values[:5]))


def test_wall_stats_counts_slow_units():
    stats = spread.wall_stats([0.1, 0.1, 0.1, 0.1, 0.3])
    assert stats["units"] == 5 and stats["slow_units"] == 1
    assert stats["slow_share"] == pytest.approx(0.3 / 0.7)


def test_parse_reads_the_run():
    res = {"correct": True, "plain_calls_on_cuda": 0,
           "metrics": {"step_s": {"value": 0.1, "unit": "s"}},
           "compared": {"loss_gap": {"value": 0.0, "limit": 1e-4}}}
    stdout = "\n".join([json.dumps({"card": "H100"}), json.dumps(res)])
    stderr = "setup_s 9.0\nunit_walls [0.1, 0.12, 0.1] loadavg (0, 0, 0)\n"
    run = spread.parse(stdout, stderr)
    assert run["walls"] == [0.1, 0.12, 0.1] and run["correct"]
    assert run["metrics"] == {"step_s": 0.1} and run["card"] == "H100"
