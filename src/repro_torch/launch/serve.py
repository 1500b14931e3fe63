"""Batched serving entry point of the port, on a CUDA card by default:

  python -m repro_torch.launch.serve --arch llama3.1-8b --batch 4 \\
      --prompt-len 512 --new-tokens 32
  python -m repro_torch.launch.serve --arch deepseek-v3-16b --batch 4 \\
      --prompt-len 512 --new-tokens 32
  python -m repro_torch.launch.serve --arch rwkv6-3b --batch 4 \\
      --prompt-len 512 --new-tokens 32
  python -m repro_torch.launch.serve --arch qwen3-4b --reduced --device cpu

Weights are random, made on the device from ``--seed``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model
from repro_torch.serve.decode import ServeConfig, ServingLoop


def resolve_device(name: str) -> torch.device:
    """The device asked for; CUDA must exist when asked (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for but CUDA is not "
                           f"available; pass --device cpu to run on the CPU")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = build_model(cfg, max_cache_len=args.prompt_len + args.new_tokens)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, device)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    loop = ServingLoop(model, params, args.batch, args.prompt_len,
                       ServeConfig(max_new_tokens=args.new_tokens,
                                   temperature=args.temperature,
                                   seed=args.seed), device=device)
    out = loop.serve(prompts)
    print(f"arch={cfg.name} device={device} generated {out.shape} tokens:")
    print(out[:, :12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
