"""CUDA graphs of `render_chunk`'s batches.

A batch of `render_chunk` (its lane keys by `sample_lane_keys`, then
`render_sample`) issues the same few thousand small launches every time,
and on the card their host dispatch, not the device, sets the pace.
`BatchGraphs` captures one batch into a `torch.cuda.CUDAGraph` and
replays it for every later batch of the same signature:

  * the signature is the device; the identity (address, shape, dtype) of
    every tensor of the scene and the camera constants; the
    configuration; the pixel shard, and the lanes and samples a batch;
    and what the batch's Python reads outside its arguments: the trace
    and RNG entry points (which comparison harnesses swap) and the pair
    grid's lane budget;
  * the first batch of a signature runs eagerly, which also warms what
    capture needs (lazily built tables, the kernel library, the
    allocator's blocks); the second is captured and replayed; every later
    one is replayed.  A new signature drops the graph and its memory pool:
    one graph at a time;
  * a replay reads its inputs by address: the key and the sample ids are
    copied into the graph's own tensors first, and the graph keeps a
    reference to everything else it reads (the scene, the camera
    constants, the pixel order), so no address is reused while it lives.
    Its outputs are the graph's own tensors, which the next replay
    overwrites: `render_chunk` adds them into its own.

A batch runs eagerly and leaves the cache alone off the card, and when
autograd records it (grad mode on and a tensor it reads requires a
gradient).  A signature whose first batch called a plain version on CUDA
tensors (a comparison harness: the plain trace walks read lane counts back
to the host, which capture refuses) stays eager.  A capture that fails
raises.

Counting under replay.  A replay runs no Python, so what the capture
counted is carried to every replay: the telemetry counts go to a
`telemetry.Record` while capturing (the device counts stay in the graph,
which rewrites them each replay), and each replay adds them again while a
profiler runs; each wrapper's `.launches` and plain version's
`.cuda_calls` get the difference it showed across the capture, which
itself counts nothing.  So every counter reads after a replayed batch what
it reads after an eager one.  The spans inside a batch (`bdpt.walks`,
`accel.*`, `rng`, ...) are absent from a replayed one; `bdpt.batch`
stays.  The counters `bdpt.graph.eager`, `.capture` and `.replay` count
the batches by how they ran.
"""
from __future__ import annotations

import functools

import torch

from .. import telemetry


def _counter_modules():
    from ..core import rng
    from ..ops import gather, threefry, trace_any, trace_closest

    return (trace_closest, trace_any, gather, threefry, rng)


def attribute_counters() -> dict:
    """{(function, attribute): count} of every wrapper's `.launches` and
    every plain version's `.cuda_calls`."""
    out = {}
    for mod in _counter_modules():
        for fn in vars(mod).values():
            for attr in ("launches", "cuda_calls"):
                n = getattr(fn, attr, None)
                if type(n) is int:
                    out[(fn, attr)] = n
    return out


def _plain_calls() -> int:
    return sum(n for (_, attr), n in attribute_counters().items()
               if attr == "cuda_calls")


def routes() -> tuple:
    """What a batch's Python reads outside its arguments: the trace and
    RNG entry points and the pair grid's lane budget."""
    from ..accel import api
    from ..core import rng
    from . import bdpt

    return (api.closest_hit, api.any_hit, api.closest_hit_stream,
            api.any_hit_stream, rng.fold_in, rng.uniform1, rng.uniform2,
            bdpt.MEGA_MAX_LANES)


def tensors(tree) -> list:
    """Every tensor in a nest of NamedTuples, dicts, lists and tuples."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in tensors(x)]


def needs_eager(device, reads) -> bool:
    """Whether a batch on `device` that reads the tensors `reads` runs
    eagerly whatever its signature: off the card, or when autograd
    records it."""
    return (torch.device(device).type != "cuda"
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in reads)))


def signature(device, reads, cfg, lanes: int, sb: int,
              pixel_shard=(0, 1)) -> tuple:
    return (torch.device(device),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in reads),
            cfg, pixel_shard, lanes, sb, routes())


class BatchGraphs:
    """A cache of one CUDA graph of a batch, keyed by its signature."""

    def __init__(self):
        self._drop(None)

    def _drop(self, sig):
        self.signature = sig
        self.next = "warm"  # how the next batch of the signature runs
        self.graph = self.inputs = self.outputs = self.record = None
        self.holds = None
        self.deltas = {}

    def plan(self, sig) -> str:
        """How the next batch of signature `sig` runs: "warm" (eagerly,
        the first of its signature), "capture", "replay", or "eager" (a
        signature that a comparison harness runs)."""
        if sig != self.signature:
            self._drop(sig)
        how = self.next
        if how == "warm":
            self.next = "capture"
        elif how == "capture":
            self.next = "replay"
        return how

    def run(self, sig, holds, batch, key, sids):
        """`batch(key, sids)` as the plan for `sig` says; `holds`: what
        the batch reads besides its arguments, kept while its graph
        lives."""
        how = self.plan(sig)
        telemetry.add("bdpt.graph." + ("eager" if how == "warm" else how), 1)
        if how == "eager":
            return batch(key, sids)
        if how == "warm":
            plain = _plain_calls()
            out = batch(key, sids)
            if _plain_calls() != plain:
                self.next = "eager"
            return out
        if how == "capture":
            try:
                self._capture(batch, key, sids, holds)
            except BaseException:
                self._drop(None)
                raise
        return self._replay(key, sids)

    def _capture(self, batch, key, sids, holds):
        inputs = (key.clone(), sids.clone())
        before = attribute_counters()
        graph = torch.cuda.CUDAGraph()
        # "thread_local": the capture refuses an unsafe CUDA call (an event
        # query, say) from this thread only.  "global" refuses one from any
        # thread, and a rank of a mesh has another: the NCCL watchdog,
        # which polls its collectives' events while the batch is captured.
        with telemetry.recording() as record, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = batch(*inputs)
        after = attribute_counters()
        for (fn, attr), n in before.items():
            setattr(fn, attr, n)
        self.deltas = {c: n - before.get(c, 0) for c, n in after.items()
                       if n != before.get(c, 0)}
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.record, self.holds = record, holds

    def _replay(self, key, sids):
        for static, x in zip(self.inputs, (key, sids)):
            static.copy_(x)
        self.graph.replay()
        self.record.replay()
        for (fn, attr), n in self.deltas.items():
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.outputs


CACHE = BatchGraphs()


def _eager(batch, key, sids):
    telemetry.add("bdpt.graph.eager", 1)
    return batch(key, sids)


def batch_runner(batch, scene, cam_consts, cfg, pixel_idx, sb: int,
                 pixel_shard=(0, 1)):
    """The function (key, sids) -> batch(key, sids) that runs the batches
    of one `render_chunk` call over the pixels `pixel_idx` of shard
    `pixel_shard`: eagerly, or through `CACHE`."""
    dev = pixel_idx.device
    reads = tensors((scene, cam_consts))
    if needs_eager(dev, reads):
        return functools.partial(_eager, batch)
    sig = signature(dev, reads, cfg, pixel_idx.shape[0] * sb, sb,
                    pixel_shard)
    return functools.partial(CACHE.run, sig, (scene, cam_consts, pixel_idx),
                             batch)
