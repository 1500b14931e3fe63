"""AdamW as plain tensor code: fp32 moments, global-norm clipping, a
warmup + cosine schedule and weight decay inside the update.

The torch counterpart of ``repro.train.optimizer``, with the same arithmetic
in the same order: the clip scale min(1, max_norm / (norm + 1e-9)), the step
incremented before the schedule and the bias corrections, and decay on every
leaf.  (``torch.optim.AdamW`` differs: it decays before the moment update
and corrects bias in another form.)  Parameter trees are nested dicts of
tensors; leaves are walked in sorted key order, as JAX flattens them.
Unlike the JAX functions, ``adamw_update`` writes the new parameters and
moments into the given tensors, in place: at full width a second copy of
the state would not fit the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import tree_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    exp_avg: Any
    exp_avg_sq: Any


def tree_map(fn, tree):
    """fn on every tensor of a nested dict tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_state(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params)).device)
    return AdamWState(step, tree_map(zeros, params), tree_map(zeros, params))


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine down to ``min_lr_frac`` of
    it at ``total_steps``; fp32, from an int32 step."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most max_norm, in fp32; the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: TrainConfig, params, grads, state: AdamWState
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step on the trees ``params`` and ``grads`` (same structure),
    written into ``params`` and the state's moments in place.  Returns
    (params, the state with its step advanced, {"grad_norm", "lr"})."""
    norm = global_norm(grads)
    scale = clip_scale(norm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.exp_avg),
                          tree_leaves(state.exp_avg_sq)):
        g = g.float() * scale                   # the clip, a leaf at a time
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        del g
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        p32 = p if p.dtype == torch.float32 else p.float()
        upd.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * upd)
    return params, AdamWState(step, state.exp_avg, state.exp_avg_sq), \
        {"grad_norm": norm, "lr": lr}
