"""Batched serving: prefill + greedy/temperature decode.

The torch counterpart of ``repro.serve.decode``: one new token per step
against a static-shape KV cache, under ``torch.inference_mode``.  Sampling
with a temperature draws from a ``torch.Generator`` seeded from
``ServeConfig.seed`` on the logits' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0 -> greedy
    seed: int = 0


def sample_token(logits, temperature: float,
                 generator: Optional[torch.Generator] = None):
    """logits: (B, 1, V) -> (B, 1) int64 token ids."""
    if temperature <= 0.0:
        return torch.argmax(logits[:, -1], dim=-1)[:, None]
    probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


@torch.inference_mode()
def generate(model, params, batch: Dict[str, Any],
             cfg: ServeConfig) -> np.ndarray:
    """Returns (B, max_new_tokens) generated ids."""
    tokens = batch["tokens"]
    gen = None
    if cfg.temperature > 0.0:
        gen = torch.Generator(device=tokens.device).manual_seed(cfg.seed)
    logits, cache = model.prefill(params, batch)
    tok = sample_token(logits, cfg.temperature, gen)
    out: List[torch.Tensor] = [tok]
    for _ in range(cfg.max_new_tokens - 1):
        logits, cache = model.decode_step(params, tok, cache)
        tok = sample_token(logits, cfg.temperature, gen)
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


class ServingLoop:
    """Minimal batched-request loop: collects requests into fixed-size
    batches (static shapes!), pads the shortfall, runs prefill+decode."""

    def __init__(self, model, params, batch_size: int, prompt_len: int,
                 cfg: Optional[ServeConfig] = None, *, device="cuda"):
        self.model = model
        self.params = params
        self.B = batch_size
        self.S = prompt_len
        self.cfg = cfg or ServeConfig()
        self.device = torch.device(device)
        # serve() writes each request batch into this preallocated (B, S)
        # host buffer and copies it to the device once
        self._pad_buf = np.zeros((self.B, self.S), np.int64)

    def serve(self, prompts: np.ndarray) -> np.ndarray:
        """prompts: (n, S) int32, n <= batch_size.  Pads to B, returns (n, T)."""
        prompts = np.asarray(prompts)
        if prompts.ndim != 2 or prompts.shape[1] != self.S:
            raise ValueError(
                f"prompts must have shape (n, {self.S}) — static shapes: "
                f"pad/truncate ragged prompts before serving; got "
                f"{prompts.shape}")
        n = prompts.shape[0]
        if n > self.B:
            raise ValueError(
                f"batch of {n} prompts exceeds batch_size={self.B}; split "
                f"the batch or raise batch_size (got {prompts.shape})")
        buf = self._pad_buf
        buf[:n] = prompts
        buf[n:] = 0
        batch = {"tokens": torch.from_numpy(buf).to(self.device)}
        toks = generate(self.model, self.params, batch, self.cfg)
        return toks[:n]
