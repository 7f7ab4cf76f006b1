"""A progressive render job over a mesh of ranks, one process a card:
each chunk's `chunk_spp` samples are rendered by the port's
parallel/mesh.py::render_chunk_sharded over the configuration's `mesh`
(`dp` x `sp` ranks, `fb_mode` "psum"), `samples_per_batch` samples a
batch on every rank, `sample_offset` advancing, and the merged
framebuffer is accumulated on rank 0's host as render_chunks does (a
closed loop).

Rank 0 is the benchmark's own process (run.py) on the first card.  It
loads the kernel library and the native BVH builder first (their build
locks are per process, so first builds in several processes would
race), then starts ranks 1..n-1 (this file run as a script), one
process a card, which meet it over a TCP store on localhost.  Each rank
builds its own scene.  Rank 0 broadcasts a command before each chunk
(render the chunk at an offset; start the profilers; report the
counters; stop).  A helper dies with rank 0 (PR_SET_PDEATHSIG), and rank
0 fails at once when a helper exits unasked.

Traffic keys as render_chunks: `chunk_spp`, `job_spp`, `check_chunks`,
`trace_units`.  In a traced run every rank runs the profiler over the
traced chunks, so that the counters of every rank count them.

End to end: rays_per_s, every ray the window's merged chunks count over
rank 0's window wall.  Compared: rank 0's merged chunk against the
reference's whole-image chunk of the same samples (render_chunks' own
reference: the unsharded render), `fb_gap` and `nrays_gap`, and
`plain_calls_other_ranks`, the plain-version calls on CUDA tensors of
ranks 1..n-1 (rank 0's are run.py's `plain_calls_on_cuda`).
"""
from __future__ import annotations

import datetime
import inspect
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import common, packages  # noqa: E402
from portbench.harness.common import span  # noqa: E402

render_chunks = common.load_module("drivers", "render_chunks")

HOST = "127.0.0.1"
TIMEOUT = datetime.timedelta(seconds=600)   # store and process group
JOIN_S = 60              # a helper's exit after the stop command
SCALING_CHUNKS = 5       # chunks of each side of the scaling probe
STOP, CHUNK, PROFILE, COUNTS = range(4)
GRAPH_KINDS = ("replay", "capture", "eager")


def _rank_device(device, rank):
    return (torch.device("cuda", rank) if torch.device(device).type == "cuda"
            else torch.device("cpu"))


class Rank:
    """One rank's program: its scene, key and place in the mesh, and the
    sharded chunk."""

    def __init__(self, config, traffic, key_seed, device):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        bdpt = packages.module(packages.PROGRAM, "integrators.bdpt")
        rng = packages.module(packages.PROGRAM, "core.rng")
        self.pm = packages.module(packages.PROGRAM, "parallel.mesh")
        self.device = device
        self.scene, _, cam = packages.scene(packages.PROGRAM, config, device)
        self.cc = cam.device_constants(device)
        self.cfg = bdpt.BDPTConfig(config["width"], config["height"],
                                   spp=traffic["job_spp"], **config["bdpt"])
        self.key = rng.key(key_seed, device)
        self.shape = config["mesh"]
        self.spp = traffic["chunk_spp"] // self.shape["sp"]
        self.sb = config["samples_per_batch"]
        self.mesh = None

    def join(self, store, rank, world):
        import torch.distributed as dist

        cuda = self.device.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo", store=store,
                                rank=rank, world_size=world,
                                timeout=TIMEOUT)
        self.mesh = self.pm.make_mesh(self.shape["dp"], self.shape["sp"])

    def chunk(self, offset):
        return self.pm.render_chunk_sharded(
            self.scene, self.cc, self.cfg, self.mesh, self.key, self.spp,
            fb_mode=self.shape["fb_mode"], sample_offset=offset,
            samples_per_batch=self.sb)

    def command(self, op=STOP, offset=0):
        """Rank 0: send (op, offset); a helper: receive it."""
        import torch.distributed as dist

        cmd = torch.tensor([op, offset], dtype=torch.int64).to(self.device)
        dist.broadcast(cmd, src=0)
        return cmd.tolist()

    def barrier(self):
        import torch.distributed as dist

        x = torch.zeros(1, device=self.device)
        dist.all_reduce(x)
        x.item()


def rank_counts() -> dict:
    """This process's batches by how they ran (the port's bdpt.graph.*
    counters, read while a profiler ran) and its plain-version calls on
    CUDA tensors."""
    from portbench import run as run_mod
    from portbench.harness import spans

    c = spans.counters() or {}
    return {"graph": {k: c.get(f"bdpt.graph.{k}", 0) for k in GRAPH_KINDS},
            "plain_calls": run_mod.program_counters()[1]}


class Cell(render_chunks.Cell):
    def __init__(self, ctx):
        super().__init__(ctx)
        shape = self.cfg_file["mesh"]
        if shape["fb_mode"] != "psum":
            raise ValueError("rank 0 sums the merged image on its host, "
                             "which needs fb_mode psum")
        self.world = shape["dp"] * shape["sp"]
        sb = self.cfg_file["samples_per_batch"]
        if sb % shape["dp"]:
            raise ValueError(f"samples_per_batch {sb} does not split over "
                             f"dp {shape['dp']}")
        # Whole-image renders (the reference, the scaling probe's one
        # card) take the lanes of a rank's batch.
        self.single_sb = sb // shape["dp"]
        self.rank = self.store = None
        self.helpers = []
        self.stopping = False
        self.seq = 0
        self.others = {}
        self.offset = 0

    def _build(self, pkg):
        b = super()._build(pkg)
        b["sb"] = self.single_sb
        return b

    # -- the world ----------------------------------------------------------
    def _start(self):
        """Rank 0's set-up: the libraries, the helpers, the scene and the
        group."""
        import torch.distributed as dist

        pm = packages.module(packages.PROGRAM, "parallel.mesh")
        params = inspect.signature(pm.render_chunk_sharded).parameters
        if not {"sample_offset", "samples_per_batch"} <= set(params):
            raise RuntimeError("the program's render_chunk_sharded has no "
                               "sample_offset and samples_per_batch")
        dev = _rank_device(self.ctx.device, 0)
        if dev.type == "cuda":
            packages.module(packages.PROGRAM, "ops._build").library()
        packages.module(packages.PROGRAM, "native.native").library()
        self.store = dist.TCPStore(HOST, 0, self.world, True,
                                   timeout=TIMEOUT, wait_for_workers=False)
        args = {"port": self.store.port, "world": self.world,
                "device": str(self.ctx.device), "config": self.cfg_file,
                "traffic": self.traffic, "key_seed": self.key_seed,
                "parent": os.getpid()}
        for r in range(1, self.world):
            self.helpers.append(subprocess.Popen(
                [sys.executable, __file__, json.dumps({**args, "rank": r})],
                stdin=subprocess.DEVNULL, stdout=2))
        threading.Thread(target=self._watch, daemon=True).start()
        self.rank = Rank(self.cfg_file, self.traffic, self.key_seed, dev)
        self.rank.join(self.store, 0, self.world)

    def _watch(self):
        """Fail rank 0 at once when a helper exits before the stop."""
        while not self.stopping:
            for r, p in enumerate(self.helpers, 1):
                rc = p.poll()
                if rc is not None and not self.stopping:
                    common.log(f"rank {r} exited with code {rc}")
                    os._exit(1)
            time.sleep(0.2)

    def _counts(self, op) -> dict:
        """Send `op` (COUNTS or STOP) and read the helpers' rank_counts."""
        self.rank.command(op)
        self.seq += 1
        got = [json.loads(self.store.get(f"counts/{self.seq}/{r}"))
               for r in range(1, self.world)]
        return {"graph": {k: sum(g["graph"][k] for g in got)
                          for k in GRAPH_KINDS},
                "plain_calls": sum(g["plain_calls"] for g in got)}

    def _sharded(self, offset):
        self.rank.command(CHUNK, offset)
        return self.rank.chunk(offset)

    # -- the program ----------------------------------------------------------
    def run(self, clock):
        """Set-up (the world, one warm chunk at offset 0), then chunks
        under `clock` until it closes the window."""
        import numpy as np

        try:
            self._start()
            self.fb = np.zeros((self.cfg_file["width"]
                                * self.cfg_file["height"], 3), np.float32)
            with span("warm"):
                fb_c, nr = self._sharded(0)
                self.fb = self.fb + fb_c.cpu().numpy()
                int(nr)
            if clock.traced:
                self.rank.command(PROFILE)
                self.rank.barrier()
            offset = self.chunk_spp
            clock.setup_done()
            while True:
                with span("render_chunk_sharded"):
                    fb_c, nr = self._sharded(offset)
                    fb_np = fb_c.cpu().numpy()
                    self.fb = self.fb + fb_np
                    n = int(nr)
                self.records.append((offset, fb_np, n))
                self.total_rays += n
                offset += self.chunk_spp
                if clock.unit_done():
                    break
            self.offset = offset
            self.others = self._counts(COUNTS)
        except BaseException:
            self._kill()
            raise

    def counts(self) -> dict:
        c = super().counts()
        c["graph_other_ranks"] = self.others.get("graph")
        return c

    def probe(self, kind):
        """"scaling": SCALING_CHUNKS sharded chunks on the world against
        rank 0 alone rendering the same samples of the whole image through
        render_chunk at `single_sb`; None off the card."""
        if kind != "scaling" or self.rank.device.type != "cuda":
            return None
        bdpt = packages.module(packages.PROGRAM, "integrators.bdpt")
        r = self.rank
        offs = [self.offset + i * self.chunk_spp
                for i in range(SCALING_CHUNKS + 1)]

        def one(off):
            return bdpt.render_chunk(r.scene, r.cc, r.cfg, r.key,
                                     self.chunk_spp, sample_offset=off,
                                     samples_per_batch=self.single_sb)

        rates = {}
        for side, render in (("world", self._sharded), ("one_card", one)):
            render(offs[0])[0].cpu()     # untimed: one card captures here
            torch.cuda.synchronize()
            t0, rays = time.perf_counter(), 0
            for off in offs[1:]:
                fb, nr = render(off)
                fb.cpu()
                rays += int(nr)
            rates[side] = rays / (time.perf_counter() - t0)
        return {"pct": 100.0 * rates["world"] / (self.world
                                                 * rates["one_card"]),
                "world_rays_per_s": rates["world"],
                "one_card_rays_per_s": rates["one_card"],
                "chunks": SCALING_CHUNKS}

    def release(self):
        """Stop the helpers and free the program's state; return what the
        check reads."""
        import torch.distributed as dist

        self.stopping = True
        self.others["plain_calls"] = self._counts(STOP)["plain_calls"]
        dist.destroy_process_group()
        for p in self.helpers:
            try:
                p.wait(JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
        self.rank = self.store = None
        return super().release()

    def _kill(self):
        self.stopping = True
        for p in self.helpers:
            p.kill()

    def check(self, records) -> dict:
        numbers = super().check(records)
        numbers["plain_calls_other_ranks"] = float(self.others["plain_calls"])
        return numbers

    def control(self, fault=None) -> dict:
        return {**super().control(fault), "plain_calls_other_ranks": 0.0}


# -- ranks 1..n-1 -------------------------------------------------------------

def _die_with_parent(parent: int):
    """SIGKILL this process when its parent exits (PR_SET_PDEATHSIG), and
    exit now if it already has."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        sys.exit(1)


def helper(args: dict) -> int:
    """Rank args["rank"]: join, then run rank 0's commands until stop."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    _die_with_parent(args["parent"])
    rank = args["rank"]
    dev = _rank_device(args["device"], rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    store = dist.TCPStore(HOST, args["port"], args["world"], False,
                          timeout=TIMEOUT)
    me = Rank(args["config"], args["traffic"], args["key_seed"], dev)
    me.join(store, rank, args["world"])
    prof, seq = None, 0
    while True:
        op, offset = me.command()
        if op == CHUNK:
            me.chunk(offset)
        elif op == PROFILE:
            prof = profile(activities=[ProfilerActivity.CPU]
                           + [ProfilerActivity.CUDA] * (dev.type == "cuda"))
            prof.start()
            me.barrier()
        else:
            if prof is not None:
                prof.stop()
                prof = None
            seq += 1
            store.set(f"counts/{seq}/{rank}", json.dumps(rank_counts()))
            if op == STOP:
                dist.destroy_process_group()
                return 0


if __name__ == "__main__":
    sys.exit(helper(json.loads(sys.argv[1])))
