"""Mixture-of-experts block: top-k router (softmax or deepseek-v3 sigmoid),
capacity-based padded dispatch (stable sort, token-dropping: the padded
grouped GEMM of the paper's §VII-C), shared experts, and the load-balancing
auxiliary loss.

The torch counterpart of ``repro.models.moe`` (its global-capacity
dispatch).  The three expert contractions, (E, C, d) x (E, d, h) and
(E, C, h) x (E, h, d), go through ``kernels.moe_gemm``: the CUDA grouped
GEMM (and its two backward kernels) on a card, its plain version on the
CPU.  The expert weights are cast to the activations' dtype at use, as
JAX casts them (fp32 masters in training).

Dispatch and combine are gathers with a trash slot, as in JAX.  The
combine gathers each token's k expert outputs back into token order and
sums them over k, and both backwards gather through the inverse maps
(``_Gather``), so no result depends on the order of atomic adds: a step
gives the same bits every run.

Sharded training (``MoEGroup``: each rank holds its rows of the global
batch) keeps JAX's global semantics: the capacity follows the global token
count, an assignment is kept by its position among all the batch's
assignments to its expert (rows rank-major, as the global batch stacks
them: one all-gather of the per-expert counts a layer), and the aux loss
uses the global expert counts, each rank's part linear in its own router
probabilities, so that the parts sum to the global aux and its gradient.
A rank's buffer holds its kept assignments only (the largest count over
experts, rounded up to 8), which asks the host for that count.  Where every
rank holds the whole batch (rows the world does not divide), each routes it
as one device would and carries 1/world of the aux.

Expert parallelism over the ``model`` axis (``moe_forward``'s ``tp``, JAX's
``experts`` -> ``model`` rule) needs no all-to-all: every model rank of a
data row routes the same gathered tokens, fills and runs only its E/m
experts' slots, and the sum over ``model`` of the ranks' combines is the
layer's output.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.models.common import ParamSpec, activation_fn
from repro_torch.models.mlp import mlp, mlp_specs


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    m = cfg.moe
    d, E, h = cfg.d_model, m.n_experts, m.d_expert
    s: Dict[str, ParamSpec] = {
        "router": ParamSpec((d, E), ("embed", "experts"), "normal", 0.02),
        "wg": ParamSpec((E, d, h), ("experts", "embed", "expert_ffn")),
        "wu": ParamSpec((E, d, h), ("experts", "embed", "expert_ffn")),
        "wd": ParamSpec((E, h, d), ("experts", "expert_ffn", "embed")),
    }
    if m.n_shared:
        # shared experts are always-on: computed as one fused wide MLP
        s["shared"] = {
            "wg": ParamSpec((d, m.n_shared * h), ("embed", "ffn")),
            "wu": ParamSpec((d, m.n_shared * h), ("embed", "ffn")),
            "wd": ParamSpec((m.n_shared * h, d), ("ffn", "embed")),
        }
    return s


@dataclass(frozen=True)
class MoEGroup:
    """The ranks a sharded step's MoE layers route over: ``split`` when each
    rank holds its own rows of the global batch (contiguous, rank-major),
    else every rank holds all of them."""
    group: Any
    world: int
    rank: int
    split: bool

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world,) + t.shape: every rank's t, in rank order."""
        out = t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out.view((self.world,) + tuple(t.shape))


def _scores(cfg, logits):
    """fp32 logits (T, E) -> (the scores top-k picks from, the probabilities
    the aux loss averages)."""
    if cfg.moe.router == "sigmoid":                # deepseek-v3 style
        scores = torch.sigmoid(logits)
        return scores, scores / (scores.sum(-1, keepdim=True) + 1e-9)
    probs = torch.softmax(logits, dim=-1)
    return probs, probs


def _aux(cfg, f_e, p_e):
    """load-balancing aux loss: E * sum_e f_e * P_e"""
    m = cfg.moe
    return m.aux_loss_weight * m.n_experts * torch.sum(f_e * p_e)


def _route(cfg, logits):
    """fp32 logits (T, E) -> (gates (T,k), idx (T,k), aux_loss scalar)."""
    m = cfg.moe
    scores, probs = _scores(cfg, logits)
    gates, idx = torch.topk(scores, m.top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    T = logits.shape[0]
    counts = torch.zeros(m.n_experts, dtype=torch.float32,
                         device=logits.device)
    counts.scatter_add_(0, idx.reshape(-1),
                        torch.ones(idx.numel(), device=logits.device))
    return gates, idx, _aux(cfg, counts / (T * m.top_k), probs.mean(0))


def capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)                  # round up to 8


class _Gather(torch.autograd.Function):
    """Rows ``[a; 0][index]`` (an index of len(a) reads the zero row), whose
    backward gathers too: ``inverse`` holds, for each row of a, the k rows
    of the output that read it (len(output) where fewer did), and a row's
    gradient is their sum over k, in order.  The dispatch (a token's row
    read by its k slots) and the combine (a slot's row read by its one
    assignment) are such gathers; autograd's own backward of a gather
    scatter-adds (by atomics on a card, and in series where many indices
    meet, as the dropped assignments do at the trash slot)."""

    @staticmethod
    def forward(ctx, a, index, inverse, k: int):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return torch.cat([a, a.new_zeros(1, a.shape[1])])[index]

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        gz = torch.cat([g, g.new_zeros(1, g.shape[1])])[inverse]
        return (gz.view(-1, ctx.k, g.shape[1]).sum(1) if ctx.k > 1 else gz,
                None, None, None)


def _dispatch_combine_local(cfg, p, xs, gates, idx, offset=None, C=None,
                            e0: int = 0):
    """Dispatch -> padded expert GEMMs -> combine.

    xs: (T, d); gates/idx: (T, k).  Slot ``se * C + pos`` holds the pos-th
    assignment (in token order) to expert se; assignments past the capacity
    C go to the trash slot and contribute zero.  ``offset`` (E,) and ``C``
    (sharded training): the assignments of the ranks before this one to
    each expert, and the global capacity; an assignment is kept where its
    global position ``offset + pos`` is below C, and the buffer holds this
    rank's kept assignments only.  ``p``'s expert weights may hold a
    contiguous block of the experts, from expert ``e0`` on (expert
    parallelism: E/m experts a rank); then the buffer holds those experts'
    slots alone, assignments to the others go to the trash slot too, and
    the result is this rank's part of the sum over experts.
    """
    m = cfg.moe
    T, d = xs.shape
    E, k = m.n_experts, m.top_k
    El = p["wg"].shape[0]
    dev = xs.device

    flat_e = idx.reshape(T * k)
    flat_t = torch.arange(T * k, device=dev) // k
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[se]
    if offset is None:
        C = capacity(cfg, T)
        keep = pos < C
    else:
        keep = offset[se] + pos < C
        kept = (C - offset).clamp_min(0).minimum(counts)[e0:e0 + El]
        C = max(8, -(-int(kept.max()) // 8) * 8)       # a read by the host
    if El != E:                                        # this rank's experts
        keep &= (se >= e0) & (se < e0 + El)
    dest = torch.where(keep, (se - e0) * C + pos, El * C)  # El*C = trash slot
    dest_tok = torch.empty_like(dest)
    dest_tok[order] = dest                                  # (t, j) order

    # slot -> source row of xs (empty slots read the zero row T), and slot
    # -> its assignment t * k + j (empty slots: T * k).  Only the trash slot
    # is written more than once, and it is never read.
    src = torch.full((El * C + 1,), T, dtype=torch.int64, device=dev)
    src[dest] = flat_t[order]
    slot_of = torch.full((El * C + 1,), T * k, dtype=torch.int64, device=dev)
    slot_of[dest] = order
    eb = _Gather.apply(xs, src[:El * C], dest_tok, k).view(El, C, d)

    # ---- grouped expert GEMMs (padded — balanced compute, paper §VII-C) ----
    act = activation_fn(cfg.activation)
    dt = xs.dtype
    h = act(moe_ops.moe_gemm(eb, p["wg"].to(dt))) * \
        moe_ops.moe_gemm(eb, p["wu"].to(dt))
    y = moe_ops.moe_gemm(h, p["wd"].to(dt))

    # ---- combine: gather back in token order, gate-weight, sum over k ------
    back = _Gather.apply(y.reshape(El * C, d), dest_tok, slot_of[:El * C], 1)
    return (back * gates.reshape(T * k, 1).to(dt)).view(T, k, d).sum(1)


def moe_forward(cfg, p, x, group: Optional[MoEGroup] = None, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  Capacity follows
    the call's own token count B * S, or under a split ``group`` the global
    batch's, with this rank's part of the global aux.

    ``tp`` (``parallel.tensor.TensorParallel``, expert parallelism): ``p``
    holds this rank's E/m experts, its router columns and its columns
    (rows) of the shared experts; ``x`` is this rank's part of the
    residual stream.  The tokens are gathered (``tp.enter``) so that every
    model rank of a data row routes the same tokens, over the router's
    logits gathered over the experts; each rank runs its experts' slots
    of the dispatch, its combine and its shared experts' partial sum add
    up, and one sum over ``model`` (``tp.leave``) makes the output; each
    model rank carries 1/m of the aux."""
    e0 = 0
    if tp is not None:
        x = tp.enter(x)
        e0 = tp.rank * p["wg"].shape[0]
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    logits = xf.float() @ p["router"].float()
    if tp is not None:
        logits = tp.gather_last(logits)
    gates, idx, aux = _route(cfg, logits)
    if group is None or not group.split:
        if group is not None:       # every rank routes the whole batch
            aux = aux / group.world
        out = _dispatch_combine_local(cfg, p, xf, gates, idx, e0=e0)
    else:
        m = cfg.moe
        counts = torch.zeros(m.n_experts, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(
            idx.reshape(-1)))
        every = group.all_gather(counts)                 # (world, E)
        T = B * S * group.world
        _, probs = _scores(cfg, logits)
        aux = _aux(cfg, every.sum(0).float() / (T * m.top_k),
                   probs.sum(0) / T)
        out = _dispatch_combine_local(cfg, p, xf, gates, idx,
                                      offset=every[:group.rank].sum(0),
                                      C=capacity(cfg, T), e0=e0)
    if cfg.moe.n_shared:
        out = out + mlp(cfg, p["shared"], xf)
    out = out.reshape(B, S, d)
    if tp is not None:
        return tp.leave(out), aux / tp.size
    return out, aux


def moe_or_mlp_specs(cfg, layer_is_dense: bool):
    if cfg.moe is None or layer_is_dense:
        d_ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                else cfg.d_ff)
        return mlp_specs(cfg, d_ff)
    return moe_specs(cfg)
