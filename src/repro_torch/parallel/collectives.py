"""Explicit collective schedules: the torch counterpart of
``repro.parallel.collectives``.

Where JAX names a mesh axis inside ``shard_map``, these take a process
group (``None``: the whole world).  ``ring_all_gather`` is the ring of
point-to-point transfers the JAX package writes with ``ppermute``;
``fsdp_ffn_prefetch`` is the software-pipelined C3 of the paper's Fig 2:
layer i+1's weight gather is issued (async, on NCCL's stream) before layer
i's matmul and waited for only where it is used, so that the transfer runs
under the compute.  ``FSDP`` (``repro_torch.parallel.fsdp``) runs the same
schedule over a model's layers on its default path, with the plain
collectives of ``repro_torch.parallel.tensor``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.tensor import all_gather_dim


def axis_size(group=None) -> int:
    """The number of ranks in ``group`` (JAX: the mesh axis's size)."""
    return dist.get_world_size(group)


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` by a ring of point-to-point transfers
    (``batch_isend_irecv``): each of n - 1 rounds sends the chunk received
    last to the next rank and receives one from the previous.  Returns
    (n,) + x.shape, the shards stacked in rank order."""
    n = axis_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group or dist.group.WORLD, (me + 1) % n)
    prv = dist.get_global_rank(group or dist.group.WORLD, (me - 1) % n)
    chunks = [x.contiguous()]                      # [mine, me-1's, me-2's, ...]
    for _ in range(n - 1):
        got = torch.empty_like(chunks[-1])
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, chunks[-1], nxt, group),
                dist.P2POp(dist.irecv, got, prv, group)]):
            req.wait()
        chunks.append(got)
    stacked = torch.stack(chunks)
    # chunk j holds rank (me - j) mod n's shard
    order = (me - torch.arange(n, device=x.device)) % n
    out = torch.empty_like(stacked)
    out[order] = stacked
    return out


def fsdp_ffn_prefetch(x: torch.Tensor, w_local: torch.Tensor,
                      group=None) -> torch.Tensor:
    """An L-layer FFN, relu(x @ w) per layer, whose weights are sharded
    over ``group`` along their input dimension: ``x`` (B_local, d) is this
    rank's rows, ``w_local`` (L, d/n, d) its shards.  Layer i+1's gather is
    issued before layer i's matmul and waited for where it is used."""
    L = w_local.shape[0]
    ahead = all_gather_dim(w_local[0], 0, group, async_op=True)
    for i in range(L):
        w = ahead.wait()
        if i + 1 < L:                  # issued before the matmul: overlaps
            ahead = all_gather_dim(w_local[i + 1], 0, group, async_op=True)
        x = torch.relu(x @ w)
    return x


def make_fsdp_prefetch_fn(group=None):
    """The JAX package's ``shard_map``-wrapped chain: ``fn(x, w)`` takes the
    whole x (B, d) and w (L, d, d), as every rank holds them, runs
    ``fsdp_ffn_prefetch`` on this rank's rows of x and block of w's input
    dimension (JAX's in_specs P(data, None) and P(None, data, None)), and
    returns the rows gathered (out_specs P(data, None))."""
    def fn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        n, me = axis_size(group), dist.get_rank(group)
        out = fsdp_ffn_prefetch(x.chunk(n)[me],
                                w.chunk(n, 1)[me].contiguous(), group)
        return all_gather_dim(out, 0, group)
    return fn
