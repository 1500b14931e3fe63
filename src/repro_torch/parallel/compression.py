"""int8 gradient compression with error feedback: the torch counterpart of
``repro.parallel.compression``.

Symmetric int8 per slice along the last axis (scale = max |x| / 127), the
quantization residual carried into the next step.  The JAX package applies
``compressed_grad_tree`` in every train step with ``grad_compression=
"int8"``, one device included: the values that would be summed across pods
are the dequantized payloads.  Plain tensor code, as AdamW is (the JAX
package has no kernel here).

A sharded leaf split along its last axis holds part of each slice on each
rank: ``amax_groups`` names the groups that split it, over which the slice's
largest magnitude is MAX-all-reduced before quantizing, so that every shard
quantizes as the whole leaf does on one device.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves
from repro_torch.train.optimizer import tree_map


def quantize_int8(x: torch.Tensor, *, axis: int = -1,
                  amax_groups: Sequence = ()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization: (q, scale)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    for group in amax_groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor,
                           amax_groups: Sequence = ()):
    """grad + carried error -> (q, scale, new_error)."""
    g = grad.float() + error
    q, s = quantize_int8(g, amax_groups=amax_groups)
    return q, s, g - dequantize_int8(q, s)


def compress_grads_(grads, errors,
                    amax_groups: Optional[Sequence[Sequence]] = None) -> None:
    """``compressed_grad_tree`` in place, a leaf at a time: each gradient
    becomes its dequantized payload and each error its new residual (at
    full width a second tree of either would not fit the card).
    ``amax_groups``: per leaf (tree order), the groups its last axis is
    split over."""
    leaves = list(zip(tree_leaves(grads), tree_leaves(errors)))
    groups = amax_groups or [()] * len(leaves)
    with torch.no_grad():
        for (g, e), gs in zip(leaves, groups):
            q, s, ne = compress_with_feedback(g, e, gs)
            g.copy_(dequantize_int8(q, s))
            e.copy_(ne)


def compressed_grad_tree(grads, errors,
                         amax_groups: Optional[Sequence[Sequence]] = None
                         ) -> Tuple[Any, Any]:
    """(dequantized gradients, new errors): the compression round trip
    with error feedback, as new trees."""
    out_g = tree_map(lambda t: t.detach().clone(), grads)
    out_e = tree_map(lambda t: t.detach().clone(), errors)
    compress_grads_(out_g, out_e, amax_groups)
    return out_g, out_e


def init_error_tree(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce over ``group``: every rank quantizes against the
    shared largest magnitude (a MAX all-reduce), the int32 payloads are
    summed, and the sum dequantized with that scale."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return (q.float() * scale).to(x.dtype)
