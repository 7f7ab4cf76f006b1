"""Run context shared by the drivers: files found by name, streams drawn
from --seed, spans, the window clock and the device's identity."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# Module names (whole top-level names) that no process of the benchmark
# may hold: JAX, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "bpt_tpu", "benchmarks")


def forbidden_modules(modules=None) -> list:
    """Top-level names in `modules` (default sys.modules) that are
    forbidden, compared as whole names: bpt_tpu_torch is allowed."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                           else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def load_json(kind: str, name: str) -> dict:
    """portbench/<kind>/<name>.json."""
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, loaded by path (metric names hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


class Seeds:
    """Every random choice of a run, drawn from --seed alone: the same
    seed gives the same render keys, start parameters and samples."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._gen = np.random.default_rng(
            np.random.SeedSequence(self.seed % 2 ** 64))

    def key_seed(self) -> int:
        """A seed for the port's threefry key."""
        return int(self._gen.integers(0, 2 ** 31 - 1))

    def generator(self) -> np.random.Generator:
        """An independent numpy generator."""
        return np.random.default_rng(self._gen.integers(0, 2 ** 63 - 1))


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    seeds and the device."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seeds: Seeds
    device: str = "cuda"

    @classmethod
    def for_cell(cls, name: str, seed: int, device: str = "cuda",
                 bench: dict | None = None):
        bench = bench or benchmark()
        cell = next(w for w in bench["workloads"] if w["name"] == name)
        return cls(cell=cell, config=load_json("configs", cell["config"]),
                   traffic=load_json("traffic", cell["traffic"]),
                   limits=load_json("limits", name)["limits"],
                   seeds=Seeds(seed), device=device)


def span(name: str):
    """A benchmark span around a call into a layer (record_function;
    costs nothing while no profiler runs)."""
    import torch

    return torch.profiler.record_function(f"portbench.{name}")


class SpanChain:
    """Back-to-back spans of one name, for units that end inside the
    program's own loop: `next()` closes the open span and opens the
    next one, `close()` closes the last."""

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def next(self):
        self.close()
        self._open = span(self.name)
        self._open.__enter__()

    def close(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class WindowClosed(Exception):
    """Raised from a driver's hook in the program's loop to end the
    window."""


def nvidia_smi() -> str:
    """The card's name, power limit, SM clock and its maximum."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def cache_env():
    """Fixed cache directories inside the checkout, set before torch
    loads (the port builds its kernels into bpt_tpu_torch/_build/)."""
    cache = BENCH_DIR / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)
