"""Shared model-building blocks: param specs, norms, activations, RoPE.

The torch counterpart of ``repro.models.common``.  A model is a tree of
``ParamSpec`` (shape, logical axes, initializer), the same tree the JAX
package builds, so that its parameters carry over path for path;
``init_params`` materializes it on one device from a ``torch.Generator``.

For serving, matrices are held in the compute dtype (``load_dtype``):
casting once at load equals the JAX code's per-use ``.astype(x.dtype)``.
Vectors (norm weights, biases) stay float32 and are cast where the JAX code
casts them.  Two matrices stay float32 too, because the JAX code reads them
in fp32 from fp32 parameters: the MoE router (the matrix whose output axis
is ``experts``), whose logits it computes in fp32, and RWKV's time-first
bonus ``u`` (path ``.../tm/u``, shape (H, D)), which enters the fp32 WKV
recurrence as it is.  For training every leaf is float32 (the JAX
package's ``param_dtype``, ``trainable``), and the models cast each matrix
to the activations' dtype where they use it, as the JAX code does.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rms_ops

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --------------------------------------------------------------------------- #
# Param specs
# --------------------------------------------------------------------------- #
class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | embed
    scale: float = -1.0               # -1 -> 1/sqrt(fan_in)


def _fan_in(shape: Tuple[int, ...]) -> int:
    # stacked layer axes don't count toward fan-in
    return shape[-2] if len(shape) >= 2 else shape[-1]


def tree_map_specs(fn: Callable[[Tuple[str, ...], ParamSpec], Any], tree,
                   path: Tuple[str, ...] = ()):
    """Apply ``fn(path, spec)`` to every ParamSpec of a nested-dict tree."""
    if isinstance(tree, ParamSpec):
        return fn(path, tree)
    return {k: tree_map_specs(fn, v, path + (k,)) for k, v in tree.items()}


# leaves read in fp32 by the JAX code, by the last keys of their path
_FLOAT32_LEAVES = {("tm", "u")}       # RWKV time_first (models/rwkv.py)


def load_dtype(path: Tuple[str, ...], spec: ParamSpec,
               compute_dtype: torch.dtype) -> torch.dtype:
    """Matrices in the compute dtype; vectors (norms, biases), the MoE
    router and RWKV's ``u`` in float32.  A stacked 'layers' axis does not
    count toward the rank."""
    rank = len(spec.shape) - (spec.axes[:1] == ("layers",))
    if rank < 2 or spec.axes[-1:] == ("experts",) \
            or tuple(path[-2:]) in _FLOAT32_LEAVES:
        return torch.float32
    return compute_dtype


def init_params(spec_tree, generator: torch.Generator, *,
                dtype: torch.dtype, device) -> Dict[str, Any]:
    """Random parameters made directly on ``device`` (the generator's)."""
    def make(path, spec: ParamSpec) -> torch.Tensor:
        dt = load_dtype(path, spec, dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        scale = spec.scale
        if scale < 0:
            scale = 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))
        if spec.init == "embed":
            scale = 0.02
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dt)
    return tree_map_specs(make, spec_tree)


def tree_leaves(tree):
    """The tensors of a nested dict (or list) tree, dict keys in sorted
    order: the order ``jax.tree_util`` flattens the same tree in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def trainable(tree):
    """Make every leaf of a float32 parameter tree a leaf tensor that
    autograd gives a gradient (in place); returns the tree."""
    for t in tree_leaves(tree):
        if t.dtype != torch.float32:
            raise TypeError(f"training parameters are float32 (param_dtype); "
                            f"got a {t.dtype} leaf of shape {tuple(t.shape)}")
        t.requires_grad_(True)
    return tree


def stack_specs(spec_tree, n: int):
    """Prepend a stacked 'layers' axis to every spec in a layer's spec tree."""
    return tree_map_specs(
        lambda _p, s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                s.init, s.scale), spec_tree)


def layer_views(stacked, n: int):
    """A tree stacked along a leading 'layers' axis -> n per-layer trees of
    views, one ``unbind`` per leaf: its backward stacks the n layers'
    gradients in one pass, where a view per ``t[i]`` would add a zero-filled
    copy of the whole stacked leaf for each layer."""
    def split(t):
        return ({k: split(v) for k, v in t.items()}
                if isinstance(t, dict) else t.unbind(0))

    def pick(t, i):
        return ({k: pick(v, i) for k, v in t.items()}
                if isinstance(t, dict) else t[i])
    parts = split(stacked)
    return [pick(parts, i) for i in range(n)]


# --------------------------------------------------------------------------- #
# Norms / activations
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """fp32 RMSNorm, output in x's dtype; the CUDA kernel on a card."""
    return rms_ops.rmsnorm(x, weight, eps=eps)


def layernorm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


def norm_spec(cfg, d: int) -> Dict[str, ParamSpec]:
    if cfg.norm == "layernorm":
        return {"w": ParamSpec((d,), (None,), "ones"),
                "b": ParamSpec((d,), (None,), "zeros")}
    return {"w": ParamSpec((d,), (None,), "ones")}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":          # jax.nn.gelu's default: the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "squared_relu":
        return lambda x: torch.relu(x).square()
    raise ValueError(f"unknown activation {name}")


def softcap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


# --------------------------------------------------------------------------- #
# RoPE (half-split form)
# --------------------------------------------------------------------------- #
def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for given positions: (..., head_dim//2) each."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2).  fp32 rotation."""
    d = x.shape[-1]
    xf1 = x[..., : d // 2].float()
    xf2 = x[..., d // 2:].float()
    cos, sin = cos[..., None, :], sin[..., None, :]             # head axis
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
def cross_entropy_loss(logits, labels, z_loss_weight: float = 0.0,
                       ignore_index: int = -100):
    """Mean CE over non-ignored tokens, with an optional z-loss regularizer
    (the weight times the mean squared log-partition).

    logits: (..., V) any float dtype, taken in fp32; labels: (...) ints.
    The mean's denominator is the count of non-ignored tokens, at least 1.
    """
    logits = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, -1)
    ll = torch.take_along_dim(logits, safe[..., None], -1)[..., 0]
    ce = (lse - ll) * mask
    n = mask.sum()
    denom = n.clamp_min(1)
    loss = ce.sum() / denom
    metrics = {"ce_loss": loss, "tokens": n}
    if z_loss_weight:
        zl = z_loss_weight * (lse.square() * mask).sum() / denom
        metrics["z_loss"] = zl
        loss = loss + zl
    return loss, metrics


# --------------------------------------------------------------------------- #
# Misc
# --------------------------------------------------------------------------- #
def pad_vocab(v: int, multiple: int = 128) -> int:
    """Pad vocab so TP over the production mesh divides evenly."""
    return -(-v // multiple) * multiple


def take_embedding(table, tokens):
    return table[tokens]
