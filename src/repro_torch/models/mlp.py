"""Dense MLP blocks (gated silu/gelu, squared-relu non-gated)."""
from __future__ import annotations

from typing import Dict

from repro_torch.models.common import ParamSpec, activation_fn


def mlp_specs(cfg, d_ff: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    s = {"wd": ParamSpec((d_ff, d), ("ffn", "embed"))}
    if cfg.gated_mlp:
        s["wg"] = ParamSpec((d, d_ff), ("embed", "ffn"))
    s["wu"] = ParamSpec((d, d_ff), ("embed", "ffn"))
    return s


def mlp(cfg, p, x):
    act = activation_fn(cfg.activation)
    if cfg.gated_mlp:
        h = act(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = act(x @ p["wu"])
    return h @ p["wd"]
