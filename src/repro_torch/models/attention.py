"""Attention: GQA SDPA (grouped, no K/V repeat), qk-norm, biases, causal and
sliding masks, and one-token decode over a KV cache.

The torch counterpart of ``repro.models.attention`` for the dense family.
Multi-token attention (prefill) goes through ``kernels.flash_attention``:
the CUDA kernel on a card (the role of the JAX package's ``"pallas"``
path), its plain online-softmax version on the CPU (the role of
``"chunked"``'s ``sdpa_flash``).  Decode (one query) stays plain torch, as
the JAX package sends it to the jnp oracle too.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import ParamSpec, apply_rope, rmsnorm, rope_freqs


# --------------------------------------------------------------------------- #
# Specs
# --------------------------------------------------------------------------- #
def attn_specs(cfg) -> Dict[str, ParamSpec]:
    """Self-attention projection specs (logical axes as in the JAX package)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, qd), ("embed", "heads")),
        "wk": ParamSpec((d, kvd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kvd), ("embed", "kv_heads")),
        "wo": ParamSpec((qd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((qd,), ("heads",), "zeros")
        s["bk"] = ParamSpec((kvd,), ("kv_heads",), "zeros")
        s["bv"] = ParamSpec((kvd,), ("kv_heads",), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((cfg.head_dim,), (None,), "ones")
        s["k_norm"] = ParamSpec((cfg.head_dim,), (None,), "ones")
    return s


# --------------------------------------------------------------------------- #
# Projections
# --------------------------------------------------------------------------- #
def project_q(cfg, p, x, positions=None):
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if positions is not None and cfg.pos_embedding == "rope":
        cos, sin = rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
    return q


def project_kv(cfg, p, x, positions=None):
    B, S, _ = x.shape
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None and cfg.pos_embedding == "rope":
        cos, sin = rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
        k = apply_rope(k, cos, sin)
    return k, v


# --------------------------------------------------------------------------- #
# Masks
# --------------------------------------------------------------------------- #
def make_mask(Sq: int, Sk: int, *, causal: bool, window: int = 0,
              offset: int = 0, device=None):
    """(Sq, Sk) bool mask.  offset = absolute position of query 0 minus key 0."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    ki = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window:
        m &= ki > qi - window
    return m


# --------------------------------------------------------------------------- #
# Core SDPA (grouped-query, fp32 softmax)
# --------------------------------------------------------------------------- #
def sdpa(q, k, v, mask=None):
    """q: (B,Sq,H,D), k/v: (B,Sk,kvH,D); returns (B,Sq,H,D) in v's dtype,
    as the JAX einsums give it.

    GQA is computed grouped (q reshaped to (kvH, group)), so K/V are never
    materialized H-wide.  The softmax weights are cast to v's dtype before
    the value product, as in the JAX package.
    """
    B, Sq, H, D = q.shape
    kvH = k.shape[2]
    G = H // kvH
    qg = q.reshape(B, Sq, kvH, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * D ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), v.float())
    return out.to(v.dtype).reshape(B, Sq, H, D)


def sdpa_auto(q, k, v, *, causal, window_eff=0, q_offset=0, mask=None):
    """Multi-token attention through the flash kernel (plain version on the
    CPU); one-token attention through the grouped ``sdpa``."""
    if q.shape[1] > 1:
        return fa_ops.flash_attention(q, k, v, mask, causal=causal,
                                      window=window_eff, q_offset=q_offset)
    Sq, Sk = q.shape[1], k.shape[1]
    m = make_mask(Sq, Sk, causal=causal, window=window_eff, offset=q_offset,
                  device=q.device)
    if mask is not None:
        m &= mask
    return sdpa(q, k, v, m)


def attention(cfg, p, x, positions, *, causal=True, window_eff=0):
    """Self-attention for prefill (and the forward pass).  Returns (B,S,d)."""
    q = project_q(cfg, p, x, positions)
    k, v = project_kv(cfg, p, x, positions)
    out = sdpa_auto(q, k, v, causal=causal, window_eff=window_eff)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.q_dim) @ p["wo"].to(x.dtype)


# --------------------------------------------------------------------------- #
# Decode over caches
# --------------------------------------------------------------------------- #
def cache_update(k_cache, v_cache, k_new, v_new, pos: int):
    """Insert (B,1,kvH,D) entries at slot ``pos``, in place."""
    k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def decode_attention(cfg, p, x, pos: int, k_cache, v_cache):
    """One-token decode: x (B,1,d), full-length caches (B,W,kvH,D), updated
    in place (the JAX package returns new caches; here the old ones are
    dead after the step).  Returns out, caches."""
    B = x.shape[0]
    W = k_cache.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = project_q(cfg, p, x, positions)
    k_new, v_new = project_kv(cfg, p, x, positions)
    k_cache, v_cache = cache_update(k_cache, v_cache, k_new, v_new, pos)
    kpos = torch.arange(W, device=x.device)
    valid = kpos <= pos
    if cfg.window:
        valid &= kpos > pos - cfg.window
    out = sdpa(q, k_cache, v_cache, valid)
    out = out.reshape(B, 1, cfg.q_dim).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, k_cache, v_cache
