"""End-to-end training entry point of the port, on a CUDA card by default:

  python -m repro_torch.launch.train --arch llama3.1-8b --layers 8 \\
      --global-batch 2 --seq-len 4096 --steps 10 --use-case gpu-red
  python -m repro_torch.launch.train --arch llama3.1-8b --reduced \\
      --steps 30 --lr 3e-3 --device cpu
  python -m repro_torch.launch.train --arch deepseek-v3-16b --layers 5 \\
      --global-batch 2 --seq-len 4096 --steps 10 --use-case gpu-red
  python -m repro_torch.launch.train --arch deepseek-v3-16b --reduced \\
      --steps 30 --lr 3e-3 --device cpu

and sharded (FSDP, ZeRO-3 over the ``data`` axis; with ``--model-parallel
N`` tensor, sequence and expert parallel over a ``model`` axis of N), one
process per card, or per CPU process with gloo:

  torchrun --nproc_per_node 8 -m repro_torch.launch.train \\
      --arch llama3.1-8b --global-batch 8 --seq-len 4096 --steps 10
  torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --arch deepseek-v3-16b --layers 16 --global-batch 4 --seq-len 4096 \\
      --steps 8 --checkpoint-every 0
  python -m torch.distributed.run --nproc_per_node 2 \\
      -m repro_torch.launch.train --arch llama3.1-8b --reduced --steps 30 \\
      --lr 3e-3 --device cpu
  torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --arch llama3.1-8b --global-batch 4 --seq-len 4096 --steps 8 \\
      --checkpoint-every 0 --model-parallel 4
  python -m torch.distributed.run --nproc_per_node 4 \\
      -m repro_torch.launch.train --arch deepseek-v3-16b --reduced \\
      --steps 30 --lr 3e-3 --device cpu --model-parallel 2

The flags of ``python -m repro.launch.train``, plus ``--device``,
``--model-parallel`` and ``--layers`` (a depth cut at full width:
full-depth llama3.1-8b's fp32 parameters, gradients and AdamW moments,
~128 GB, do not fit one card, but do fit a node's cards sharded; an MoE
model keeps its dense first layers and cuts the MoE ones).  Under torchrun
(``WORLD_SIZE`` above 1 in the environment) it builds the host mesh of
shape (world / N, N) for ``--model-parallel N``
(``make_host_mesh(model_parallel=N)``) and trains sharded; only rank 0
prints (the mesh's shape first) and writes ``--metrics-out``.
``--model-parallel`` above 1 without torchrun raises.  Runs synthetic
data -> loss (per-layer activation checkpoints) -> backward -> AdamW ->
atomic checkpoints -> watchdog -> the Lit Silicon power-management co-sim
hook (detect + mitigate per paper §V).  Weights are random, made on the
device from the training seed.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the mesh's 'model' axis (torchrun only)")
    args = ap.parse_args(argv)

    from repro_torch.configs import TrainConfig, get_config, get_reduced_config
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.train.data import DataConfig
    from repro_torch.train.train_loop import (LitSiliconHook, Trainer,
                                              TrainerConfig)

    device = resolve_device(args.device)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from repro_torch.parallel.mesh import make_host_mesh
        mesh = make_host_mesh(model_parallel=args.model_parallel,
                              device=device.type)
    elif args.model_parallel != 1:
        raise RuntimeError(f"--model-parallel {args.model_parallel} needs "
                           f"that many processes or more: start them with "
                           f"torchrun (WORLD_SIZE above 1)")
    rank0 = mesh is None or mesh.get_rank() == 0
    if mesh is not None and rank0:
        print(f"mesh (data, model) = {tuple(mesh.mesh.shape)} over "
              f"{mesh.size()} {device.type} processes", flush=True)
    model_cfg = (get_reduced_config(args.arch) if args.reduced
                 else get_config(args.arch))
    if args.layers:
        dense = model_cfg.moe.first_k_dense if model_cfg.moe else 0
        if args.layers <= dense:
            ap.error(f"--layers {args.layers}: {args.arch} keeps its "
                     f"{dense} dense first layer(s), so it needs more")
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
    if args.use_case and rank0:
        hooks.append(LitSiliconHook(
            get_config(args.arch),       # sim runs the FULL arch workload
            ManagerConfig(use_case=args.use_case, sampling_period=2,
                          warmup=3, window_size=2),
            preset=args.preset))
    try:
        trainer = Trainer(tc, hooks=hooks, device=device, mesh=mesh)
        log = trainer.run(args.steps)
        trainer.ckpt.wait()
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if not rank0:
        return 0
    world = "" if mesh is None else f" world={mesh.size()}"
    print(f"arch={model_cfg.name} device={device}{world} step "
          f"{log[-1]['step']}: "
          f"loss {log[-1]['loss']:.4f} (start {log[0]['loss']:.4f})")
    step_s = float(np.median(trainer.watchdog.step_times[1:]
                             or trainer.watchdog.step_times))
    peak = (f"; rank 0 peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if device.type == "cuda" else "")
    print(f"{step_s * 1e3:.1f} ms/step (host clock, median after the first "
          f"step) = {args.global_batch * args.seq_len / step_s:.0f} "
          f"tokens/s on {device.type}{peak}")
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
