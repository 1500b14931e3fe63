"""Tensor, sequence and expert parallelism over the mesh's ``model`` axis:
the collectives of a step, written out.

The JAX package has no module of this name: there GSPMD inserts these
collectives from ``ShardingRules`` (heads, kv heads, ffn, vocab and experts
over ``model``, ``repro.parallel.sharding``) and from the residual
stream's ``act_seq`` constraint (``repro.parallel.act.shard_residual``).
The port runs the same layout on plain local tensors with the collectives
as ``torch.autograd.Function``s over the ``model`` group, as
``repro_torch.parallel.fsdp`` does for the ``data`` axis (not ``DTensor``:
the kernels are called through ctypes on raw pointers and need plain
contiguous tensors).

A block whose weights are split over ``model`` (Megatron-style: q/k/v, gate
and up by columns, wo and wd by rows) is entered and left through
``TensorParallel.enter`` and ``leave``:

  * with sequence parallelism (``sequence_parallel=True``, JAX's default)
    the residual stream and the norms hold this rank's contiguous ``S/m``
    rows; ``enter`` all-gathers the sequence (its backward reduce-scatters)
    and ``leave`` reduce-scatters the row products' partial sums over the
    sequence (its backward all-gathers);
  * without it the residual stream is whole on every rank; ``enter`` is a
    copy whose backward all-reduces, ``leave`` an all-reduce whose
    backward is the identity.

A block that runs whole on every model rank (attention whose heads the
axis does not divide, where JAX keeps wq, wk, wv and wo whole) goes
through ``enter_whole`` and ``leave_whole``: the gather alone, then this
rank's rows of the output (``act.shard_residual``), not a sum.

Every collective is the identity's equal at a ``model`` axis of 1, where
no ``TensorParallel`` is made at all.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.parallel.act import shard_residual


# --------------------------------------------------------------------------- #
# Plain collectives along one dimension
# --------------------------------------------------------------------------- #
class Pending:
    """A collective issued with ``async_op=True``: its buffers are held
    here until ``wait``, which makes the caller's (current) stream wait
    for it (on NCCL; on gloo the host waits) and returns the result.
    ``out``: the output buffer, not to be read before ``wait``."""

    def __init__(self, work, out: torch.Tensor, keep=(), finish=None):
        self.work, self.out, self.keep, self.finish = work, out, keep, finish

    def wait(self) -> torch.Tensor:
        self.work.wait()
        self.keep = ()
        return self.out if self.finish is None else self.finish(self.out)


def all_gather_dim(local: torch.Tensor, dim: int, group,
                   async_op: bool = False):
    """Every rank's ``local`` joined along ``dim``, in rank order (a
    ``Pending`` of it with ``async_op``)."""
    world = dist.get_world_size(group)
    shape = tuple(local.shape)
    local = local.contiguous()
    buf = local.new_empty((world * shape[0],) + shape[1:])
    work = dist.all_gather_into_tensor(buf, local, group=group,
                                       async_op=async_op)

    def joined(buf):
        if dim == 0:
            return buf
        full = shape[:dim] + (world * shape[dim],) + shape[dim + 1:]
        return buf.view((world,) + shape).movedim(0, dim).reshape(full)
    if async_op:
        return Pending(work, buf, keep=(local,), finish=joined)
    return joined(buf)


def reduce_scatter_dim(full: torch.Tensor, dim: int, group,
                       async_op: bool = False):
    """This rank's block along ``dim`` of the sum over ranks of ``full``
    (a ``Pending`` of it with ``async_op``)."""
    world = dist.get_world_size(group)
    shape = tuple(full.shape)
    local = shape[:dim] + (shape[dim] // world,) + shape[dim + 1:]
    parts = full.reshape(shape[:dim] + (world,) + local[dim:]).movedim(dim, 0)
    parts = parts.reshape((world * local[0],) + local[1:]).contiguous()
    out = full.new_empty(local)
    work = dist.reduce_scatter_tensor(out, parts, op=dist.ReduceOp.SUM,
                                      group=group, async_op=async_op)
    return Pending(work, out, keep=(parts,)) if async_op else out


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction over ranks, in place."""
    dist.all_reduce(t, op=op, group=group)
    return t


# --------------------------------------------------------------------------- #
# The differentiable collectives
# --------------------------------------------------------------------------- #
class _CopyIn(torch.autograd.Function):
    """Identity forward, all-reduce backward: a whole activation entering
    a block split over ``model`` without sequence parallelism (JAX: the
    replicated residual stream meeting a weight split over ``model``,
    whose partial input gradients GSPMD sums)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a row
    product (wo, wd) made whole on every rank, and the vocab-parallel
    lookup's and cross-entropy's sums (JAX: the psum GSPMD places where a
    contraction runs over a dimension split over ``model``)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward along ``dim``: the
    sequence gathered before a block's column products under sequence
    parallelism (JAX: ``shard_residual``'s ``act_seq`` → ``model``
    constraint meeting an op that needs every row), and the router's
    logits gathered over the experts (JAX: the router's ``experts`` →
    ``model`` rule meeting ``top_k`` over every expert).  The gathered
    tensor's gradient is a partial sum on each rank."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _ScatterDim(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward along ``dim``: the row
    products' partial sums summed onto this rank's sequence rows under
    sequence parallelism (JAX: a psum over ``model`` fused with the
    ``act_seq`` constraint into a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


# --------------------------------------------------------------------------- #
# The model group
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``model`` axis in a step: the group, its
    size and this rank's index; ``seq``: the residual stream holds this
    rank's ``S/size`` rows (sequence parallelism; the sequence divides)."""
    group: Any
    size: int
    rank: int
    seq: bool

    # ---- blocks split over model ----------------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S or S/m, d) residual part -> the whole (B, S, d) input of a
        block split over ``model``."""
        if self.seq:
            return _GatherDim.apply(x, 1, self.group)
        return _CopyIn.apply(x, self.group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """(B, S, d) partial sums of a block's row products -> their sum,
        this rank's rows of it under sequence parallelism."""
        if self.seq:
            return _ScatterDim.apply(y, 1, self.group)
        return _ReduceOut.apply(y, self.group)

    # ---- blocks whole on every model rank --------------------------------
    def enter_whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole input of a block every model rank runs whole."""
        return _GatherDim.apply(x, 1, self.group) if self.seq else x

    def leave_whole(self, y: torch.Tensor) -> torch.Tensor:
        """A whole block's (B, S, d) output -> this rank's part of the
        residual stream: its rows under sequence parallelism, no sum."""
        return shard_residual(y) if self.seq else y

    # ---- pieces ----------------------------------------------------------
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group (backward: the identity)."""
        return _ReduceOut.apply(x, self.group)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined along the last dimension (backward:
        the reduce-scatter of partial gradients)."""
        return _GatherDim.apply(x, x.dim() - 1, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise largest over the group (no gradient)."""
        return all_reduce(x.detach().clone(), self.group, dist.ReduceOp.MAX)


def vocab_embedding(table: torch.Tensor, tokens: torch.Tensor,
                    tp: TensorParallel) -> torch.Tensor:
    """This rank's part of a vocab-parallel lookup: ``table`` holds the
    rows ``[rank * n, (rank + 1) * n)`` of the embedding; a token outside
    them reads zero, so the sum over ``model`` (``tp.leave``) is the
    lookup (JAX: ``take`` from a table whose ``vocab`` axis is split over
    ``model``)."""
    n = table.shape[0]
    local = tokens - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, 0)]
    return rows.masked_fill(~inside[..., None], 0)
