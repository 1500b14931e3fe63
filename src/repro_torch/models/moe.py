"""Mixture-of-experts block: top-k router (softmax or deepseek-v3 sigmoid),
capacity-based padded dispatch (stable sort, token-dropping: the padded
grouped GEMM of the paper's §VII-C), shared experts, and the load-balancing
auxiliary loss.

The torch counterpart of ``repro.models.moe`` on one device (its
``"scatter"`` dispatch).  The three expert contractions, (E, C, d) x
(E, d, h) and (E, C, h) x (E, h, d), go through ``kernels.moe_gemm``: the
CUDA grouped GEMM on a card, its plain version on the CPU.

Dispatch and combine are gathers with a trash slot, as in JAX, and never
ask the host for a count: no boolean-mask indexing.  The combine gathers
each token's k expert outputs back into token order and sums them over k,
so its result does not depend on the order of atomic adds.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

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


def _route(cfg, logits):
    """fp32 logits (T, E) -> (gates (T,k), idx (T,k), aux_loss scalar)."""
    m = cfg.moe
    if m.router == "sigmoid":                      # deepseek-v3 style
        scores = torch.sigmoid(logits)
        gates, idx = torch.topk(scores, m.top_k, dim=-1)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    # load-balancing aux loss: E * sum_e f_e * P_e
    T = logits.shape[0]
    counts = torch.zeros(m.n_experts, dtype=torch.float32,
                         device=logits.device)
    counts.scatter_add_(0, idx.reshape(-1),
                        torch.ones(idx.numel(), device=logits.device))
    f_e = counts / (T * m.top_k)
    p_e = probs.mean(0)
    aux = m.aux_loss_weight * m.n_experts * torch.sum(f_e * p_e)
    return gates, idx, aux


def capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)                  # round up to 8


def _dispatch_combine_local(cfg, p, xs, gates, idx):
    """Dispatch -> padded expert GEMMs -> combine.

    xs: (T, d); gates/idx: (T, k).  Slot ``se * C + pos`` holds the pos-th
    assignment (in token order) to expert se; assignments past the capacity
    C go to the trash slot E * C and contribute zero.
    """
    m = cfg.moe
    T, d = xs.shape
    E, k = m.n_experts, m.top_k
    C = capacity(cfg, T)
    dev = xs.device

    flat_e = idx.reshape(T * k)
    flat_t = torch.arange(T * k, device=dev) // k
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[se]
    dest = torch.where(pos < C, se * C + pos, E * C)       # E*C = trash slot

    # slot -> source row of xs; empty slots read the zero row T.  Only the
    # trash slot is written twice, and it is never read.
    src = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    src[dest] = flat_t[order]
    xz = torch.cat([xs, xs.new_zeros(1, d)])
    eb = xz[src[:E * C]].view(E, C, d)

    # ---- grouped expert GEMMs (padded — balanced compute, paper §VII-C) ----
    act = activation_fn(cfg.activation)
    h = act(moe_ops.moe_gemm(eb, p["wg"])) * moe_ops.moe_gemm(eb, p["wu"])
    y = moe_ops.moe_gemm(h, p["wd"])

    # ---- combine: gather back in token order, gate-weight, sum over k ------
    yflat = torch.cat([y.reshape(E * C, d), y.new_zeros(1, d)])
    dest_tok = torch.empty_like(dest)
    dest_tok[order] = dest                                  # (t, j) order
    back = yflat[dest_tok] * gates.reshape(T * k, 1).to(xs.dtype)
    return back.view(T, k, d).sum(1)


def moe_forward(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  Capacity follows
    the call's own token count B * S."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    logits = xf.float() @ p["router"].float()
    gates, idx, aux = _route(cfg, logits)
    out = _dispatch_combine_local(cfg, p, xf, gates, idx)
    if cfg.moe.n_shared:
        out = out + mlp(cfg, p["shared"], xf)
    return out.reshape(B, S, d), aux


def moe_or_mlp_specs(cfg, layer_is_dense: bool):
    if cfg.moe is None or layer_is_dense:
        d_ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                else cfg.d_ff)
        return mlp_specs(cfg, d_ff)
    return moe_specs(cfg)
