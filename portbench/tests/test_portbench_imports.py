"""Nothing the benchmark loads imports JAX, the JAX package (bpt_tpu) or
the JAX package's benchmarks, compared by whole top-level module names
(bpt_tpu_torch, the port, starts with bpt_tpu and is allowed); the
reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from portbench.harness import common

SOURCES = sorted(common.BENCH_DIR.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_is_a_whole_name_comparison():
    mods = ["bpt_tpu_torch", "bpt_tpu_torch.ops", "jaxlib.xla", "numpy",
            "bpt_tpu", "benchmarks_x", "jax_like"]
    assert common.forbidden_modules(mods) == ["bpt_tpu", "jaxlib"]
    assert common.forbidden_modules(["bpt_tpu.scene.obj"]) == ["bpt_tpu"]
    assert common.forbidden_modules(["benchmarks.baseline_small"]) == \
        ["benchmarks"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(common.BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert common.forbidden_modules(_top_level_imports(path)) == []


@pytest.mark.parametrize("path", sorted(
    (common.BENCH_DIR / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(common.BENCH_DIR)))
def test_reference_imports_nothing_of_the_program(path):
    assert "bpt_tpu_torch" not in _top_level_imports(path)


def _fresh(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=common.ROOT,
        capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.split()


def test_harness_loads_no_forbidden_module():
    """A fresh interpreter that loads run.py, every driver and reader
    and the reference holds no forbidden module."""
    found = _fresh("""
        import sys
        sys.path.insert(0, ".")
        from portbench import run, control
        from portbench.harness import common, roofline, trace, clock
        from portbench.reference.bpt.diff import inverse
        from portbench.reference.bpt.integrators import bdpt
        import bpt_tpu_torch.diff.inverse
        import bpt_tpu_torch.integrators.bdpt
        for kind in ("drivers", "metrics"):
            for p in sorted((common.BENCH_DIR / kind).glob("*.py")):
                common.load_module(kind, p.stem)
        print(*common.forbidden_modules() or ["none"])
    """)
    assert found == ["none"]


def test_reference_alone_loads_no_program():
    found = _fresh("""
        import sys
        sys.path.insert(0, ".")
        from portbench.reference.bpt.diff import inverse
        from portbench.reference.bpt.integrators import bdpt
        from portbench.harness import roofline
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"bpt_tpu_torch", "bpt_tpu", "jax"}) or "none")
    """)
    assert found == ["none"]
