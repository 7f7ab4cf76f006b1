"""A card case of a cell that needs more cards than the host has is
skipped with its reason: on one card the four-card cell's run.py exits
3 ("needs 4 CUDA cards"), which says nothing of the program."""
from __future__ import annotations

import pytest


def pytest_collection_modifyitems(config, items):
    from portbench.harness import common

    chips = {w["name"]: w["chips"] for w in common.benchmark()["workloads"]}
    for item in items:
        cell = getattr(item, "callspec", None) and \
            item.callspec.params.get("cell")
        if item.get_closest_marker("cuda") is None or cell not in chips:
            continue
        import torch

        have = torch.cuda.device_count()
        if chips[cell] > max(have, 1):
            item.add_marker(pytest.mark.skip(
                reason=f"{cell} needs {chips[cell]} CUDA cards, "
                       f"{have} present"))
