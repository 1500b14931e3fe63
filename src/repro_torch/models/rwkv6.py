"""RWKV6 "Finch" model: token-shifted time-mix (data-dependent decay WKV) +
channel-mix blocks, with an O(1) decode state.

The torch counterpart of ``repro.models.rwkv6.RWKV6LM``, in the shape of the
port's ``DecoderOnlyLM``: the parameter tree keeps the JAX layout (layers
stacked under ``blocks``), split at run time into a per-layer ``layers``
list walked by a Python loop in place of ``lax.scan``.

The cache holds the JAX keys, each a per-layer list: ``tm_shift`` and
``cm_shift`` (B, 1, d) in bf16 whatever the compute dtype (cast to it on use
and back on store, as JAX does), ``wkv`` (B, H, D, D) in fp32, and ``pos``.
Prefill and decode replace the list entries in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import rwkv as rk
from repro_torch.models.common import (COMPUTE_DTYPES, ParamSpec, apply_norm,
                                       init_params, layer_views, norm_spec,
                                       pad_vocab, stack_specs, take_embedding)


class RWKV6LM:
    def __init__(self, cfg, *, max_cache_len: int = 0):
        # max_cache_len is accepted as build_model passes it to every
        # family; the decode state does not grow with the context
        self.cfg = cfg
        self.vp = pad_vocab(cfg.vocab_size)
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]

    # ------------------------------------------------------------- structure
    def _block_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"ln1": norm_spec(cfg, cfg.d_model),
                "tm": rk.time_mix_specs(cfg),
                "ln2": norm_spec(cfg, cfg.d_model),
                "cm": rk.channel_mix_specs(cfg)}

    def param_specs(self) -> Dict[str, Any]:
        """The JAX package's spec tree, layers stacked under ``blocks``."""
        cfg = self.cfg
        return {
            "embed": ParamSpec((self.vp, cfg.d_model), ("vocab", "embed"),
                               "embed"),
            "ln0": norm_spec(cfg, cfg.d_model),     # rwkv post-embed norm
            "blocks": stack_specs(self._block_specs(), cfg.n_layers),
            "final_norm": norm_spec(cfg, cfg.d_model),
            "lm_head": ParamSpec((cfg.d_model, self.vp), ("embed", "vocab")),
        }

    def split_layers(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Stacked ``blocks`` -> ``layers``: a list of per-layer trees
        (views)."""
        out = {k: v for k, v in tree.items() if k != "blocks"}
        out["layers"] = layer_views(tree["blocks"], self.cfg.n_layers)
        return out

    def init_params(self, generator: torch.Generator, device) -> Dict[str, Any]:
        """Random parameters on ``device`` from ``generator``, split by layer."""
        return self.split_layers(init_params(
            self.param_specs(), generator, dtype=self.dtype, device=device))

    def _embed(self, params, tokens):
        x = take_embedding(params["embed"], tokens).to(self.dtype)
        return apply_norm(self.cfg, params["ln0"], x)

    def _logits(self, params, x):
        cfg = self.cfg
        x = apply_norm(cfg, params["final_norm"], x)
        logits = x @ params["lm_head"]
        if self.vp != cfg.vocab_size:                 # mask padded vocab rows
            pad = torch.arange(self.vp, device=x.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits

    # --------------------------------------------------------------- forward
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits (B, S, V) and a zero aux loss."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        for lp in params["layers"]:
            h = apply_norm(cfg, lp["ln1"], x)
            x = x + rk.time_mix(cfg, lp["tm"], h)[0]
            h = apply_norm(cfg, lp["ln2"], x)
            x = x + rk.channel_mix(cfg, lp["cm"], h)[0]
        return self._logits(params, x), torch.zeros((), device=x.device)

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, device,
                   dtype=torch.bfloat16) -> Dict[str, Any]:
        cfg = self.cfg
        H, D = rk.rwkv_dims(cfg)
        L, d = cfg.n_layers, cfg.d_model

        def per_layer(shape, dt):
            return [torch.zeros(shape, dtype=dt, device=device)
                    for _ in range(L)]
        return {"tm_shift": per_layer((batch, 1, d), dtype),
                "wkv": per_layer((batch, H, D, D), torch.float32),
                "cm_shift": per_layer((batch, 1, d), dtype),
                "pos": 0}

    def _run_with_state(self, params, tokens, cache):
        cfg = self.cfg
        x = self._embed(params, tokens)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(cfg, lp["ln1"], x)
            tms = cache["tm_shift"][i]
            out, shift, cache["wkv"][i] = rk.time_mix(
                cfg, lp["tm"], h, shift_state=tms.to(h.dtype),
                wkv_state=cache["wkv"][i])
            cache["tm_shift"][i] = shift.to(tms.dtype)
            x = x + out
            h = apply_norm(cfg, lp["ln2"], x)
            cms = cache["cm_shift"][i]
            out, shift = rk.channel_mix(cfg, lp["cm"], h,
                                        shift_state=cms.to(h.dtype))
            cache["cm_shift"][i] = shift.to(cms.dtype)
            x = x + out
        return x

    def prefill(self, params, batch, cache=None):
        """tokens: (B, S) -> the last position's logits (B, 1, V) and the
        cache."""
        tokens = batch["tokens"]
        if cache is None:
            cache = self.init_cache(tokens.shape[0], tokens.device)
        x = self._run_with_state(params, tokens, cache)
        cache["pos"] = tokens.shape[1]
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, tokens, cache):
        """tokens: (B, 1) -> (logits (B, 1, V), cache), the cache updated in
        place."""
        x = self._run_with_state(params, tokens, cache)
        cache["pos"] += 1
        return self._logits(params, x), cache
