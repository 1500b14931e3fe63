"""End-to-end training entry point of the port, on a CUDA card by default:

  python -m repro_torch.launch.train --arch llama3.1-8b --layers 8 \\
      --global-batch 2 --seq-len 4096 --steps 10 --use-case gpu-red
  python -m repro_torch.launch.train --arch llama3.1-8b --reduced \\
      --steps 30 --lr 3e-3 --device cpu

The flags of ``python -m repro.launch.train``, plus ``--device`` and
``--layers`` (a depth cut at full width: full-depth llama3.1-8b's fp32
parameters, gradients and AdamW moments, ~128 GB, do not fit one card).
Runs synthetic data -> loss (per-layer activation checkpoints) -> backward
-> AdamW -> atomic checkpoints -> watchdog -> the Lit Silicon
power-management co-sim hook (detect + mitigate per paper §V).  Weights are
random, made on the device from the training seed.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.launch.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep it)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--use-case", default="",
                    choices=["", "gpu-red", "gpu-realloc", "cpu-slosh"],
                    help="enable the Lit Silicon power-management hook")
    ap.add_argument("--preset", default="mi300x", choices=["mi300x", "v5e"])
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import TrainConfig, get_config, get_reduced_config
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.train.data import DataConfig
    from repro_torch.train.train_loop import (LitSiliconHook, Trainer,
                                              TrainerConfig)

    device = resolve_device(args.device)
    model_cfg = (get_reduced_config(args.arch) if args.reduced
                 else get_config(args.arch))
    if args.layers:
        model_cfg = model_cfg.replace(n_layers=args.layers)
    tc = TrainerConfig(
        model=model_cfg,
        train=TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps,
                          checkpoint_every=args.checkpoint_every,
                          checkpoint_dir=args.checkpoint_dir),
        data=DataConfig(global_batch=args.global_batch,
                        seq_len=args.seq_len),
    )
    hooks = []
    if args.use_case:
        hooks.append(LitSiliconHook(
            get_config(args.arch),       # sim runs the FULL arch workload
            ManagerConfig(use_case=args.use_case, sampling_period=2,
                          warmup=3, window_size=2),
            preset=args.preset))
    trainer = Trainer(tc, hooks=hooks, device=device)
    log = trainer.run(args.steps)
    trainer.ckpt.wait()
    print(f"arch={model_cfg.name} device={device} step {log[-1]['step']}: "
          f"loss {log[-1]['loss']:.4f} (start {log[0]['loss']:.4f})")
    if args.use_case:
        h = hooks[0]
        caps = h.backend.get_power_caps()
        print(f"lit-silicon[{args.use_case}]: converged caps = "
              f"{np.round(caps, 0).tolist()}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=1, sort_keys=True, allow_nan=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
