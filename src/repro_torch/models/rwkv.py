"""RWKV6 "Finch" blocks: time-mix with data-dependent decay + channel-mix.

The torch counterpart of ``repro.models.rwkv``.  The WKV recurrence

    S_t = diag(exp(w_t)) S_{t-1} + k_t^T v_t,
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

goes through ``kernels.rwkv6_wkv.ops.wkv6`` in both cases the JAX code
splits (its chunked form ``wkv_chunked`` for S > 1, ``wkv_step`` for one
token): prefill from the cache's state and each decode step from the carried
state are one call, the CUDA kernel on a card.  Both compute the same
recurrence in fp32 and differ only in summation order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.common import ParamSpec

_MIX_NAMES = ("r", "k", "v", "w", "g")


def rwkv_dims(cfg) -> Tuple[int, int]:
    H = cfg.d_model // cfg.rwkv.head_dim
    return H, cfg.rwkv.head_dim


def time_mix_specs(cfg) -> Dict[str, ParamSpec]:
    c = cfg.rwkv
    d = cfg.d_model
    H, Dh = rwkv_dims(cfg)
    return {
        "maa_x": ParamSpec((d,), (None,), "zeros"),
        "maa": ParamSpec((5, d), (None, None), "zeros"),        # r,k,v,w,g bases
        "tm_w1": ParamSpec((d, 5 * c.mix_lora), ("embed", None), "normal", 0.01),
        "tm_w2": ParamSpec((5, c.mix_lora, d), (None, None, "embed"),
                           "normal", 0.01),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "w0": ParamSpec((d,), (None,), "zeros"),
        "w1": ParamSpec((d, c.decay_lora), ("embed", None), "normal", 0.01),
        "w2": ParamSpec((c.decay_lora, d), (None, "embed"), "normal", 0.01),
        "u": ParamSpec((H, Dh), (None, None), "normal", 1.0),   # time_first
        "ln_x_w": ParamSpec((d,), (None,), "ones"),
        "ln_x_b": ParamSpec((d,), (None,), "zeros"),
    }


def channel_mix_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h = cfg.d_ff
    return {
        "maa_k": ParamSpec((d,), (None,), "zeros"),
        "maa_r": ParamSpec((d,), (None,), "zeros"),
        "wk": ParamSpec((d, h), ("embed", "ffn")),
        "wv": ParamSpec((h, d), ("ffn", "embed")),
        "wr": ParamSpec((d, d), ("embed", None)),
    }


def _token_shift(x, last=None):
    """Shift right by one along time; position 0 gets `last` (or zeros)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _time_mix_inputs(cfg, p, x, shifted):
    """Data-dependent 5-way token-shift interpolation -> dict of mixed
    inputs.  The fp32 vectors are cast to x's dtype, as JAX casts them."""
    dx = shifted - x
    xxx = x + dx * p["maa_x"].to(x.dtype)
    B, S, _ = x.shape
    lora = torch.tanh(xxx @ p["tm_w1"])
    lora = lora.reshape(B, S, 5, cfg.rwkv.mix_lora)
    lora = torch.einsum("bsfm,fmd->bsfd", lora, p["tm_w2"])
    return {name: x + dx * (p["maa"][i].to(x.dtype) + lora[:, :, i])
            for i, name in enumerate(_MIX_NAMES)}


def _decay(cfg, p, xw):
    """Per-channel log-decay (< 0), fp32: log w = -exp(w0 + lora_w(xw))."""
    lw = torch.tanh(xw @ p["w1"]) @ p["w2"]
    return -torch.exp(torch.clamp(p["w0"].float() + lw.float(), -20.0, 10.0))


def _group_norm(x, w, b, H, eps=1e-5):
    """GroupNorm with H groups over the flattened head dim (RWKV ln_x), in
    fp32, output in x's dtype."""
    B, S, d = x.shape
    xg = x.reshape(B, S, H, d // H).float()
    mu = xg.mean(-1, keepdim=True)
    var = (xg - mu).square().mean(-1, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    out = xg.reshape(B, S, d) * w.float() + b.float()
    return out.to(x.dtype)


def time_mix(cfg, p, x, shift_state=None, wkv_state=None):
    """Full time-mix layer.  x: (B, S, d).  Returns (out, shift state (B, 1,
    d) in x's dtype, wkv state (B, H, D, D) fp32)."""
    B, S, d = x.shape
    H, D = rwkv_dims(cfg)
    shifted = _token_shift(x, shift_state)
    mixed = _time_mix_inputs(cfg, p, x, shifted)

    def heads(name, wname):
        return (mixed[name] @ p[wname]).reshape(B, S, H, D)
    r, k, v = heads("r", "wr"), heads("k", "wk"), heads("v", "wv")
    g = F.silu(mixed["g"] @ p["wg"])
    w_log = _decay(cfg, p, mixed["w"]).reshape(B, S, H, D)
    y, wkv_state = wkv_ops.wkv6(r, k, v, w_log, p["u"], wkv_state)
    y = _group_norm(y.reshape(B, S, d), p["ln_x_w"], p["ln_x_b"], H) * g
    return y @ p["wo"], x[:, -1:], wkv_state


def channel_mix(cfg, p, x, shift_state=None):
    shifted = _token_shift(x, shift_state)
    dx = shifted - x
    xk = x + dx * p["maa_k"].to(x.dtype)
    xr = x + dx * p["maa_r"].to(x.dtype)
    k = torch.relu(xk @ p["wk"]).square()
    v = k @ p["wv"]
    r = torch.sigmoid(xr @ p["wr"])
    return r * v, x[:, -1:]
