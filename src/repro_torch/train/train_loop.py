"""Trainer: the end-to-end loop, on one device or sharded over a mesh's
``data`` axis (ZeRO-3) and split over its ``model`` axis (tensor, sequence
and expert parallelism), and the Lit Silicon co-sim hook.

The torch counterpart of ``repro.train.train_loop``: synthetic batches ->
the model's loss (each layer under an activation checkpoint) -> backward ->
int8 compression with error feedback (``grad_compression="int8"``) ->
global-norm clip and AdamW -> atomic/async checkpoints -> watchdog rollback
-> hooks.  ``LitSiliconHook`` has the JAX package's body: each real training
step advances the thermal/C3 node simulation one iteration and feeds its
trace to the PowerManager, which tunes per-device power caps online.

Given a mesh (``repro_torch.parallel.mesh.make_host_mesh``, one process per
card), ``Trainer`` holds the state sharded (``repro_torch.parallel.fsdp``),
also at a world of one, so that one card runs the same code: every rank
draws the same global batch and takes its rows, the loss and the gradient
norm are global, so the watchdog reads the same verdict on every rank; the
hooks run on global rank 0 only (the hook simulates the paper's 8-device
node whatever the world size); checkpoints are written whole, in the JAX
layout, leaf by leaf (every rank gathers each leaf, rank 0 writes it), and
every rank restores its shard.  Without a mesh it trains on one
device, unsharded.  The dense and MoE families train; RWKV6 models raise
until the WKV6 kernel has a backward pass.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.core.backends import SimBackend
from repro_torch.core.c3sim import NodeSim, SimConfig
from repro_torch.core.manager import ManagerConfig, PowerManager
from repro_torch.core.thermal import PRESETS
from repro_torch.core.workload import fsdp_llm_iteration
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.parallel.compression import compress_grads_, init_error_tree
from repro_torch.parallel.fsdp import FSDP, TrainState, check_parallel
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, SyntheticTokens
from repro_torch.train.fault import Watchdog, WatchdogConfig
from repro_torch.train.optimizer import adamw_update, init_state, tree_map

# what a later slice brings, by model family
_NOT_TRAINED = {
    "rwkv": "RWKV6 training needs the WKV6 backward (ROADMAP.md slice 10)",
}


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
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    data: DataConfig = field(default_factory=DataConfig)


class Trainer:
    """``mesh``: a ("data", "model") ``DeviceMesh`` over the processes of
    the world (``make_host_mesh``), each on ``device``; None trains on one
    device, unsharded."""

    def __init__(self, cfg: TrainerConfig,
                 hooks: Optional[List[Callable]] = None, device="cuda",
                 mesh=None):
        if cfg.model.family in _NOT_TRAINED:
            raise NotImplementedError(
                f"{cfg.model.name}: {_NOT_TRAINED[cfg.model.family]}")
        check_parallel(cfg.parallel)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but CUDA is not "
                               f"available; pass device='cpu' to train on "
                               f"the CPU")
        self.cfg = cfg
        self.model = build_model(cfg.model)
        self.fsdp = (None if mesh is None else
                     FSDP(self.model, mesh, cfg.parallel, self.device))
        self.rank = 0 if self.fsdp is None else \
            torch.distributed.get_rank()
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
        params = (self.model.init_train_params(gen, self.device)
                  if self.fsdp is None else self.fsdp.init_params(gen))
        err = (init_error_tree(params)
               if self.cfg.parallel.grad_compression == "int8" else None)
        return TrainState(params, init_state(params), err)

    def init_or_restore(self) -> None:
        self.state = self._init_state(self.cfg.train.seed)
        self.step = 0
        latest = self._latest_step()
        if latest is not None:
            self._restore(latest)

    def _latest_step(self) -> Optional[int]:
        """The newest complete checkpoint: rank 0's, once its writer is
        done, so that every rank restores the same one (or none)."""
        if self.fsdp is None:
            return self.ckpt.latest_step()
        self.ckpt.wait()
        step = self.ckpt.latest_step() if self.rank == 0 else None
        t = torch.tensor([-1 if step is None else step], device=self.device)
        torch.distributed.broadcast(t, 0)
        return None if int(t) < 0 else int(t)

    def _restore(self, step: int) -> None:
        """Checkpoint ``step``, loaded into the current state's tensors (each
        rank its shards)."""
        shard = None
        if self.fsdp is not None:
            where = self.fsdp.state_placements(self.state.err is not None)
            shard = lambda key, t: self.fsdp.shard(t, where[key])  # noqa: E731
        _, manifest = self.ckpt.restore(self.state, step, shard=shard)
        self.step = manifest["step"]

    # ------------------------------------------------------------------ step
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Loss, backward, the int8 round trip (with error feedback), clip
        and AdamW on the state, in place; returns the step's metrics
        (tensors).  The gradients (after the round trip) stay on the
        parameters (``.grad``) until the next step."""
        params = self.state.params
        for p in tree_leaves(params):
            p.grad = None
        if self.fsdp is None:
            loss, metrics = self.model.loss(params, batch)
            loss.backward()
            metrics = {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            norm = None
        else:
            metrics = self.fsdp.loss_and_backward(params, batch)
        grads = tree_map(lambda p: p.grad, params)
        if self.state.err is not None:
            compress_grads_(grads, self.state.err, None if self.fsdp is None
                            else self.fsdp.last_axis_groups)
        if self.fsdp is not None:
            norm = self.fsdp.global_norm(grads)
        _, opt, om = adamw_update(self.cfg.train, params, grads,
                                  self.state.opt, norm=norm)
        self.state = self.state._replace(opt=opt)
        metrics.update(om)
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
            for hook in self.hooks if self.rank == 0 else ():
                hook(self.step, metrics, self)
            self.metrics_log.append(metrics)
            self.step += 1
            if (self.cfg.train.checkpoint_every
                    and self.step % self.cfg.train.checkpoint_every == 0):
                self.save()
        return self.metrics_log

    def save(self) -> Optional[str]:
        """Checkpoint the state (sharded: gathered and written leaf by leaf
        by rank 0; the other ranks return None)."""
        extra = {"model": self.cfg.model.name}
        if self.fsdp is None:
            return self.ckpt.save(self.step, self.state, extra=extra)
        return self.ckpt.save_leaves(
            self.step, self.fsdp.state_leaves(self.state), extra=extra,
            write=self.rank == 0)

    def _rollback(self) -> None:
        latest = self._latest_step()
        if latest is None:
            # no checkpoint yet: re-init (counts against watchdog budget);
            # the old state goes first, two would not fit the card
            self.state = None
            self.state = self._init_state(self.cfg.train.seed + 1)
            self.step = 0
            return
        self._restore(latest)
