"""Trainer: the end-to-end loop on one device, and the Lit Silicon co-sim
hook.

The torch counterpart of ``repro.train.train_loop``: synthetic batches ->
the model's loss (each layer under an activation checkpoint) -> backward ->
global-norm clip and AdamW -> atomic/async checkpoints -> watchdog rollback
-> hooks.  ``LitSiliconHook`` has the JAX package's body: each real training
step advances the thermal/C3 node simulation one iteration and feeds its
trace to the PowerManager, which tunes per-device power caps online.

One device and no mesh: the multi-card (FSDP) node is a later slice.  The
dense family trains; MoE and RWKV6 models raise until their kernels have
backward passes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.backends import SimBackend
from repro_torch.core.c3sim import NodeSim, SimConfig
from repro_torch.core.manager import ManagerConfig, PowerManager
from repro_torch.core.thermal import PRESETS
from repro_torch.core.workload import fsdp_llm_iteration
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, SyntheticTokens
from repro_torch.train.fault import Watchdog, WatchdogConfig
from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                         init_state, tree_map)

# what a later slice brings, by model family
_NOT_TRAINED = {
    "moe": "MoE training needs the grouped GEMM's backward (ROADMAP.md "
           "slice 8)",
    "rwkv": "RWKV6 training needs the WKV6 backward (ROADMAP.md slice 10)",
}


class TrainState(NamedTuple):
    """The JAX package's TrainState without its grad-compression error
    feedback (multi-card only): the same checkpoint keys."""
    params: Any
    opt: AdamWState


class LitSiliconHook:
    """Co-simulation hook: real training step + simulated node physics."""

    def __init__(self, model_cfg: ModelConfig, manager_cfg: ManagerConfig,
                 preset: str = "mi300x", n_devices: int = 8,
                 sim: Optional[SimConfig] = None, seed: int = 0):
        wl = fsdp_llm_iteration(model_cfg, batch=2, seq=min(
            4096, model_cfg.max_seq_len), n_shards=n_devices)
        self.node = NodeSim(wl, PRESETS[preset], sim or SimConfig(seed=seed),
                            n_devices, seed=seed)
        self.backend = SimBackend(self.node)
        self.manager = PowerManager(self.backend, manager_cfg)

    def __call__(self, step: int, metrics: Dict[str, Any], trainer) -> None:
        trace = self.backend.run_iteration()
        self.manager.on_iteration(step, trace)
        h = self.node.history[-1]
        metrics["sim/throughput"] = h["throughput"]
        metrics["sim/node_power"] = float(np.sum(h["power"]))
        metrics["sim/freq_min"] = float(np.min(h["freq"]))
        metrics["sim/freq_max"] = float(np.max(h["freq"]))


@dataclass
class TrainerConfig:
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)


class Trainer:
    def __init__(self, cfg: TrainerConfig,
                 hooks: Optional[List[Callable]] = None, device="cuda"):
        if cfg.model.family in _NOT_TRAINED:
            raise NotImplementedError(
                f"{cfg.model.name}: {_NOT_TRAINED[cfg.model.family]}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but CUDA is not "
                               f"available; pass device='cpu' to train on "
                               f"the CPU")
        self.cfg = cfg
        self.model = build_model(cfg.model)
        self.data = SyntheticTokens(cfg.data, cfg.model)
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                      keep=cfg.train.keep_checkpoints)
        self.watchdog = Watchdog(WatchdogConfig(), clock=time.monotonic)
        self.hooks = hooks or []
        self.metrics_log: List[Dict[str, Any]] = []
        self.state: Optional[TrainState] = None
        self.step = 0

    # ------------------------------------------------------------------ init
    def _init_state(self, seed: int) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init_train_params(gen, self.device)
        return TrainState(params, init_state(params))

    def init_or_restore(self) -> None:
        self.state = self._init_state(self.cfg.train.seed)
        self.step = 0
        if self.ckpt.latest_step() is not None:
            self._restore()

    def _restore(self) -> None:
        """The latest checkpoint, loaded into the current state's tensors."""
        _, manifest = self.ckpt.restore(self.state)
        self.step = manifest["step"]

    # ------------------------------------------------------------------ step
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Loss, backward, clip and AdamW on the state, in place; returns the
        step's metrics (tensors).  The gradients stay on the parameters
        (``.grad``) until the next step."""
        params = self.state.params
        for p in tree_leaves(params):
            p.grad = None
        loss, metrics = self.model.loss(params, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        _, opt, om = adamw_update(self.cfg.train, params, grads,
                                  self.state.opt)
        self.state = self.state._replace(opt=opt)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss.detach()
        return metrics

    def run(self, n_steps: int) -> List[Dict[str, Any]]:
        if self.state is None:
            self.init_or_restore()
        for _ in range(n_steps):
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in
                     self.data.batch_at(self.step).items()}
            self.watchdog.start_step()
            metrics = self.train_step(batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            verdict = self.watchdog.end_step(loss, gnorm)
            if verdict == "rollback":
                self._rollback()
                continue
            metrics = {k: (float(v) if hasattr(v, "item") else v)
                       for k, v in metrics.items()}
            metrics["step"] = self.step
            for hook in self.hooks:
                hook(self.step, metrics, self)
            self.metrics_log.append(metrics)
            self.step += 1
            if (self.cfg.train.checkpoint_every
                    and self.step % self.cfg.train.checkpoint_every == 0):
                self.save()
        return self.metrics_log

    def save(self) -> str:
        return self.ckpt.save(self.step, self.state,
                              extra={"model": self.cfg.model.name})

    def _rollback(self) -> None:
        if self.ckpt.latest_step() is None:
            # no checkpoint yet: re-init (counts against watchdog budget);
            # the old state goes first, two would not fit the card
            self.state = None
            self.state = self._init_state(self.cfg.train.seed + 1)
            self.step = 0
            return
        self._restore()
