"""Row gathers from the material and emitter tables, with a hand-written
backward.

`gather_rows(tables, ids)` returns `table[ids]` for each of a tuple of
(M, C_k) tables that share one (N,) id vector (int32 or int64, each in
[0, M)), as a `torch.autograd.Function`.  The forward is plain PyTorch
indexing.  The backward sums each table's (N, C_k) lane gradient by row,
every table that needs a gradient in one call: `gather_rows_backward`
runs the plain version `gather_rows_backward_plain` (`index_add_`) for
tensors on the CPU and launches the kernel of
bpt_tpu_torch/csrc/gather_backward.cu for CUDA tensors, or raises.  The
kernel stands in for autograd's default backward of `table[ids]`
(`index_put_` with accumulate), whose sorted-run kernel sums a run of
equal ids with one warp: it took 2.0 s of the 2.2 s config #5 descent
step on an H100.  It replaces no TPU kernel (PERF.md).

Every material and emitter table gather of the integrators and the BSDF
goes through `gather_rows`, with a gradient or without: without one,
autograd records no node and the forward alone runs.

`gather_rows_backward.launches` counts device kernel launches (two a
call with lanes: the partial sums and the final sums, else one);
`gather_rows_backward_plain.cuda_calls` counts calls of the plain version
with CUDA tensors (a comparison harness, never a route).  The span
`bpt.diff.gather_bwd` covers each backward call, and the counter
`diff.gather.lanes` adds its N while a profiler runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .. import telemetry

# The kernel's limits (csrc/gather_backward.cu): tables a call, columns a
# table.
MAX_TABLES = 4
MAX_COLS = 4
# Blocks of the kernel's persistent grid: at most _BLOCKS_PER_SM an SM, and
# no fewer than _MIN_LANES lanes a block.
_BLOCKS_PER_SM = 4
_MIN_LANES = 1024


def gather_rows_backward_plain(ids, grads, m):
    """Plain PyTorch version: for each (N, C_k) gradient, the (M, C_k)
    sums of its rows by id."""
    if ids.is_cuda:
        gather_rows_backward_plain.cuda_calls += 1
    return tuple(torch.zeros((m, g.shape[1]), dtype=g.dtype, device=g.device)
                 .index_add_(0, ids, g) for g in grads)


gather_rows_backward_plain.cuda_calls = 0


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gather_rows_backward(ids, grads, m):
    """The (M, C_k) row sums by `ids` (N,) of each (N, C_k) gradient of
    `grads`: at most MAX_TABLES float32 gradients of 1..MAX_COLS columns
    for the kernel."""
    n = ids.shape[0]
    telemetry.add("diff.gather.lanes", n)
    if ids.device.type == "cpu":
        return gather_rows_backward_plain(ids, grads, m)
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError("ids must be a 1-D int32 or int64 tensor")
    if not 1 <= len(grads) <= MAX_TABLES:
        raise ValueError(f"1 to {MAX_TABLES} gradients a call, got "
                         f"{len(grads)}")
    for g in grads:
        if (g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != n
                or not 1 <= g.shape[1] <= MAX_COLS or g.device != ids.device):
            raise ValueError(
                f"each gradient must be float32 ({n}, 1..{MAX_COLS}) on "
                f"{ids.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    cols = [g.shape[1] for g in grads]
    if m == 0:
        return tuple(torch.empty((0, c), dtype=torch.float32,
                                 device=ids.device) for c in cols)
    out = torch.empty((m * sum(cols),), dtype=torch.float32,
                      device=ids.device)
    grads = [g.contiguous() for g in grads]
    ids = ids.contiguous()
    blocks = min(-(-n // _MIN_LANES), _BLOCKS_PER_SM * _sm_count(ids.device))
    partials = torch.empty((blocks * m * sum(cols),), dtype=torch.float32,
                           device=ids.device)
    ptrs = (ctypes.c_void_p * len(grads))(*(g.data_ptr() for g in grads))
    widths = (ctypes.c_int * len(cols))(*cols)
    _build.launch("bpt_gather_rows_backward", ids.device, ids.data_ptr(),
                  int(ids.dtype == torch.int64), n, m, len(grads), ptrs,
                  widths, blocks, partials.data_ptr(), out.data_ptr())
    gather_rows_backward.launches += 2 if n else 1
    sums, at = [], 0
    for c in cols:
        sums.append(out[at:at + m * c].view(m, c))
        at += m * c
    return tuple(sums)


gather_rows_backward.launches = 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, *tables):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(ids)
        ctx.rows = tables[0].shape[0]
        return tuple(t.index_select(0, ids) for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (ids,) = ctx.saved_tensors
        need = [k for k, g in enumerate(grads)
                if g is not None and ctx.needs_input_grad[k + 1]]
        out = [None] * len(grads)
        if need:
            with telemetry.span("diff.gather_bwd"):
                sums = gather_rows_backward(ids, [grads[k] for k in need],
                                            ctx.rows)
            for k, s in zip(need, sums):
                out[k] = s
        return (None, *out)


def gather_rows(tables, ids):
    """`table[ids]` for each (M, C_k) table of `tables` (one M), with the
    backward of this module."""
    m = tables[0].shape[0]
    if any(t.dim() != 2 or t.shape[0] != m for t in tables):
        raise ValueError("gather_rows takes 2-D tables of one row count")
    return _GatherRows.apply(ids, *tables)
