"""build_model(cfg) -> model instance, for the families the port runs."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.rwkv6 import RWKV6LM
from repro_torch.models.transformer import DecoderOnlyLM

_FAMILIES = {"dense": DecoderOnlyLM, "moe": DecoderOnlyLM, "rwkv": RWKV6LM}


def build_model(cfg: ModelConfig, *, max_cache_len: int = 0):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (ROADMAP.md §1)")
    return _FAMILIES[cfg.family](cfg, max_cache_len=max_cache_len)
