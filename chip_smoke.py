"""Chip smoke test of the PyTorch port on one NVIDIA card.

  python3 chip_smoke.py              # from the root of a checkout, one card
  python3 chip_smoke.py --host-only  # phase 1, then host us per call only
  python3 chip_smoke.py --adamw-ab   # phase 1, then phases 5 and 5c with
                                     # AdamW in blocks vs whole leaves

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. the card (nvidia-smi) and the build of every CUDA kernel from csrc/;
2. each kernel against its plain PyTorch version on the card, at the shapes
   serving gives it and at small edge cases, with the kernel's, the plain
   version's and one library call's time (CUDA events, L2 flushed; for
   RMSNorm and WKV6 also the kernel kept beside the new one); each case
   reports which of its wrapper's kernels it took (``launches_by_path``:
   "wgmma" for the Hopper tensor-core kernels, "vector" for RMSNorm's
   16-byte-word kernel, "split" for the WKV6 kernels that split the state
   over blocks and lanes, "simt"/"wmma" for the ones kept for fp32 and
   inputs those cannot read); then the host time per call of each kernel
   as the models call it, and of flash's and the GEMM's library calls (host
   clock, the device left to work off the queue);
3. full-width, full-depth llama3.1-8b, then deepseek-v3-16b (MoE), then
   rwkv6-3b (attention-free, the WKV6 recurrence; random bf16 weights from
   --seed), each served through ``ServingLoop``: batch 4, prompt 512, 32
   greedy tokens, with every kernel's launch count read over that run
   alone (every flash and grouped-GEMM launch must take the wgmma path,
   every RMSNorm launch the vector path, every WKV6 launch the split path),
   then timed (host clock) and profiled (device time by kernel, busy
   share);
3m. mistral-7b (the paper's second workload, a sliding window of 4,096)
   served past its window, full width and depth: batch 4, prompt 4,608
   (the prompt itself wraps the KV cache's ring of 4,096 slots), 32
   greedy tokens, as phase 3; then a 2-layer cut, kernel path against
   plain path: the prefill's logits and ring, and 32 decode steps through
   the ring (each step's logits; the greedy tokens the same but at near
   ties);
3d. deepseek-7b (MHA), qwen2.5-32b (QKV bias, groups of 5, ~65.5 GB of
   bf16 weights on the one card) and nemotron-4-15b (LayerNorm, which
   launches no RMSNorm kernel; squared ReLU; groups of 6; a vocabulary of
   256,000) served as phase 3;
4. the kernel path against the plain path at full width: a 2-layer llama
   prefill; deepseek's MoE block alone on one bf16 input; a 2-layer (one
   dense, one MoE) deepseek prefill; a 2-layer rwkv6-3b prefill and decode
   steps;
5. training: full-width llama3.1-8b cut to 8 of its 32 layers, B 2 x S
   4096, bf16 compute on fp32 master weights, 10 steps through ``Trainer``
   with the Lit Silicon hook (gpu-red), every flash and RMSNorm forward and
   backward launch counted against the layers (the per-layer checkpoint's
   recompute doubles the forwards), the loss finite and falling, every
   parameter (every layer's slice) with a non-zero gradient; ms/step,
   tokens/s, peak memory, device-busy share; a checkpoint round trip of a
   reduced model on the card; then the loss and every gradient of a 2-layer
   full-width cut, kernel path against plain path;
5m. mistral-7b training: full width cut to 12 of its 32 layers, B 1 x S
   8192, so that the window of 4,096 binds (about 3/4 of the causal pairs
   visible), as phase 5 (10 steps, the gpu-red hook), then the 2-layer
   cut at B 1 x S 8192, kernel path against plain path;
5x. a training smoke of deepseek-7b, qwen2.5-32b and nemotron-4-15b:
   full width, 2 layers, B 1 x S 4096, 3 steps as phase 5, then the loss
   and gradients of the kernel path against the plain path;
5c. MoE training: full-width deepseek-v3-16b cut to 5 of its 28 layers
   (layer 0 dense, 4 MoE), as phase 5, with the grouped GEMM's forward,
   dgrad and wgrad launches counted too and every expert's gradient slice
   checked (the experts routed no token counted); then the 2-layer cut
   (the dense layer and one MoE layer), kernel path against plain path,
   the plain path routed as the kernel path was;
5b. FSDP training (ZeRO-3 over the ``data`` axis): one process per card
   (``torch.multiprocessing``, NCCL), as many as the machine has (at most
   8), through ``Trainer`` on the host mesh; phase 5's configuration, then
   phase 5c's (at a world of 1 its first 4 steps), at a world of 8 both at
   full depth with global batch 8 x S 4096; every rank's gradients checked
   after each step as phase 5's (a leaf split over the experts over the
   model group's union of them, the ranks failing together); the launches
   counted per rank as in phases 5 and 5c, and at a world of 1 the loss of
   each step held to the unsharded run's (the MoE run's bit for bit); the
   world size, ms/step (``Trainer.run`` of one step, the check outside it),
   tokens/s, peak memory per card, device-busy share and the device time a
   step spends in the collectives (torch.profiler: the device time under
   c10d's ``nccl:*`` annotations, and the NCCL kernels'), split into the
   model group's and the data group's, and the collectives' device time
   (NCCL's kernels and copies) split into the part that compute kernels
   overlapped and the exposed rest.  It runs through the same 2-D code as 5d, on the
   (world, 1) mesh: at a world of 1 the (1, 1) mesh, where no ``model``
   collective runs, so it still equals phases 5 and 5c.  FSDP gathers
   each layer a layer ahead and leaves its reduce-scatters in flight (the
   default path); at a world of 2 or more each configuration runs again
   gathering in place (``FSDP(prefetch=False)``) in the same spawn, on the
   same ranks and seed, and must equal the first run bit for bit (losses,
   grad norms, every rank's shards of the parameters and both moments),
   both runs' figures printed side by side;
5e. int8 gradient compression with error feedback: 3 steps of phase 5c's
   configuration with ``grad_compression="int8"``, unsharded, then through
   FSDP over an NCCL group of one (a spawned rank): losses, grad norms and
   every leaf of the state (the error too) equal bit for bit, the error
   finite;
5d. tensor, sequence and expert parallelism over the ``model`` axis, at
   a world of 2 or more (NCCL puts no two ranks of one communicator on one
   card, so a one-card machine leaves it out): phase 5b's configurations
   on the (world/2, 2) and (1, world) meshes (llama's heads, ffn and vocab
   split over ``model``, the residual stream over the sequence;
   deepseek's experts E/m a rank), the launches per rank equal to phases
   5 and 5c's and on the same paths, each step's loss within TP_LOSS_TOL
   of phase 5b's at the same world, finite and falling, and the same
   figures as 5b;
6. the device time alone (torch.profiler) of RMSNorm and WKV6, the new
   kernels and the ones kept beside them (L2 flushed), and of the backward
   kernels (flash's wgmma kernels and the simt ones kept beside them,
   RMSNorm's, the grouped GEMM's dgrad and wgrad), their plain versions and
   the library's backward (torch.bmm for the GEMMs), after the served and
   trained runs, whose host timings a profiler session would slow; then
   phase 7b's population profiled (busy share over its warm and its
   first call, device time by kernel);
7. the fleet simulator, at the cluster/* scenarios' settings (run right
   after phase 2, before any profiler session, since it reads host
   clocks): 7a, a 4-node dp fleet on ``engine="torch"`` (the window-scan
   kernel on the card) against ``engine="vector"`` on the host, 20
   iterations, every trace matrix at rtol 1e-9 with equal NaN patterns,
   then the managed fleet (``FleetPowerManager``, gpu-realloc, 120
   iterations) with equal caps and history, ms an iteration of both; 7b,
   ``run_fleet_scan`` over 64 fleets of 256 nodes of 8 devices (30 + 120
   iterations, summary, the window scan's draw form: the seconds of a
   first and a second call, launches, peak memory; a host profile,
   cProfile, of its iterations), the vector engine's host ms for one
   256-node iteration beside ``torch_iteration``'s, the scan's kernel path
   against its plain path (the same keys, dp, pp, tp, spikes on, rtol
   1e-12), the scan on the card against the same call on the CPU in the
   CPU tests' six cases (rtol 1e-9, the slowest and straggler nodes
   equal), one fleet with the full collection, pp and tp at 16 fleets
   (``jax_normal`` under tp); 7c, 3 fleets of 4 nodes through the scan
   against ``ClusterSim`` stepped on the host, tail means within rel 5e-3;
   after phase 6, the scan's launches an iteration at 16 and 64 fleets
   (torch.profiler), which must be equal;
8. the JSON line of the kernels, then the JSON line of the device.

Phase 2 also holds the float64 window scan (``c3_window``, the fleet
simulator's kernel) against its plain version at rtol 1e-12, in emit and
summary modes: one 256-node fleet, groups of 3 and 12 (shared memory), no
collective (Km 0), a window with no kernel; durations shifted by one comm
must fail; its time at 7b's population shape.  Then the draw form
(``c3_window_draw``: the noise drawn in the kernel from the JAX package's
threefry2x32 streams) against its plain version (``core/prng.py`` draws,
then the plain scan) at rtol 1e-12, reporting the elements not bit-equal:
one 256-node fleet, groups of 3 and 12, the population, spikes on; a
sample key off by one and the iteration's datum off by one must fail;
``jax_normal`` against its plain version; the draw form's time at the
population beside the generator path it replaced (per-sample
generator draws, elementwise passes, the read form) in turns, and its
operations bound (INT32 and FP64, counted from the run's data).  It also holds the backward kernels (flash attention's dQ, dK, dV
from the forward's log-sum-exp, "wgmma" for bf16 D 64/128 and "simt" for
the rest; RMSNorm's dx, dw; the grouped GEMM's dgrad and wgrad, "wgmma"
for bf16 that TMA can read and "simt" for the rest) against their plain
versions and against autograd of the plain forward; at flash's and the
grouped GEMM's training shapes it also checks that the wgmma kernels give
the same bits twice (and at flash's holds the kept simt kernels to the
plain backward); groups of 5 and 6 at D 128 both ways; and the windowed
forward and backward at phase 5m's attention (B 1, S 8192, 32/8 heads, D
128, window 4096) against their plain versions, timed against their bound
and against flex_attention (compiled, with a sliding-window BlockMask)
and F.scaled_dot_product_attention with the window as a boolean mask
(rows "flash_attention_window" and "flash_attention_bwd_window" of the
kernels line, whose launches are those of phases 3m and 5m); these two
are also held row by row, where the same kernels with the window moved by
a 64-key tile must fail.

It needs ``src/repro_torch`` beside it, and CUDA; without either it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import prng, torch_engine  # noqa: E402
from repro_torch.core.backends import ClusterSimBackend  # noqa: E402
from repro_torch.core.c3sim import (C3Sim, SimConfig,  # noqa: E402
                                    vector_iteration, workload_arrays)
from repro_torch.core.cluster import ClusterConfig, ClusterSim  # noqa: E402
from repro_torch.core.manager import (FleetManagerConfig,  # noqa: E402
                                      ManagerConfig, run_fleet_closed_loop)
from repro_torch.core.thermal import PRESETS, ChurnEvent, ChurnModel  # noqa: E402
from repro_torch.core.workload import (CommKernel, CompKernel,  # noqa: E402
                                       Workload, fsdp_llm_iteration)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.c3_window import ops as c3_ops  # noqa: E402
from repro_torch.kernels.c3_window.kernel import (  # noqa: E402
    c3_window_draw_scan, c3_window_scan, jax_normal_draw)
from repro_torch.kernels.c3_window.ref import (  # noqa: E402
    c3_window_draw_ref, c3_window_ref, jax_normal_ref)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_dgrad  # noqa: E402
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_fwd  # noqa: E402
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_wgrad  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_dgrad_ref  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_wgrad_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_fwd  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.decode import ServeConfig, ServingLoop  # noqa: E402
from repro_torch.train.checkpoint import flatten_with_paths  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.train_loop import (LitSiliconHook, Trainer,  # noqa: E402
                                          TrainerConfig)

# H100 SXM data sheet (dense, 700 W): the card's least time for a function
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.float64: 34e12}     # float64 outside the tensor cores
# 32-bit integer operations (adds, logic, funnel shifts): 64 INT32 lanes an
# SM against the 128 FP32 lanes behind 67 TFLOP/s (an FMA two operations),
# Hopper architecture white paper: a quarter of the fp32 rate
INT32_OPS_PER_S = 67e12 / 4
# the draw form's operations, counted from csrc/c3_window.cu: a threefry2x32
# call is 2 + 20 rounds x 3 (add, funnel-shift rotate, xor) + 5 key
# injections x 2 32-bit operations (a key's derivation: fold_in, split), a
# draw 4 more to form the counter and the 52-bit mantissa; float64, an FMA
# two: the normal's uniform 3, erfinv ~70 (its log ~26 and a ~20-term
# polynomial), the product by sqrt(2) 1; a factor exp(sigma z) 1 + exp ~26
# more; a [0, 1) uniform 1; the scan's work per lane and kernel: 2
# products, 2 divisions of ~9 each, 4 sums and differences
KEY_INT_OPS = 72
DRAW_INT_OPS = KEY_INT_OPS + 4
NORMAL_FP64_FLOPS = 3 + 70 + 1
FACTOR_FP64_FLOPS = NORMAL_FP64_FLOPS + 1 + 26
UNIFORM_FP64_FLOPS = 1
SCAN_FP64_FLOPS = 2 + 18 + 4
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# kernel path vs plain path, 2-layer full-width bf16 prefill logits: the two
# paths round to bf16 at the same points but sum in another order, so values
# on a rounding boundary move one bf16 step (2**-8 relative), and such flips
# compound through 2 layers; the logits are of unit scale
E2E_TOL = {"max_abs": 0.25, "mean_abs": 0.02}
# kernel path vs plain path, deepseek's MoE block alone on one bf16 input:
# the router sees the same bits, so only the expert GEMMs' summation order
# differs; each output is a bf16 rounding of order-1 sums (one step 2**-8
# relative), and a flipped rounding of h moves y by far less than a step, so
# allow a few steps, compounded through 3 GEMMs, SiLU, gates and the sum
MOE_BLOCK_TOL = {"max_abs": 2 ** -5, "mean_abs": 1e-3}
# 2-layer deepseek prefill: layer 0's differences (a bf16 step here and
# there) can reorder a near-tied 6th/7th router score in layer 1, so some
# tokens take another expert set; that cannot happen to most tokens
MAX_FLIPPED_SHARE = 0.5
# WKV6 kernel vs plain: the JAX package's WKV tolerances
# (tests/test_kernels.py), atol 5e-4 fp32, 5e-2 bf16.  Both run the fp32 recurrence and differ only in
# summation order; in bf16 each rounds y once at the end, so a y on a rounding
# boundary lands one bf16 step (2**-7 relative) apart, which at |y| >= 8 (the
# serving shape reaches ~12) exceeds 5e-2: hence the rtol of one step for bf16
WKV_TOL = {torch.float32: (5e-4, 0.0), torch.bfloat16: (5e-2, 2 ** -7)}
KERNELS = [fa_ops.flash_attention_fwd, rms_ops.rmsnorm_fwd,
           moe_ops.moe_gemm_fwd, wkv_ops.wkv6_fwd, fa_ops.flash_attention_bwd,
           rms_ops.rmsnorm_bwd, moe_ops.moe_gemm_dgrad, moe_ops.moe_gemm_wgrad]
# the kernel every served or trained launch of each wrapper must take
SERVED_PATH = {"flash_attention_fwd": "wgmma", "rmsnorm_fwd": "vector",
               "moe_gemm_fwd": "wgmma", "wkv6_fwd": "split",
               "flash_attention_bwd": "wgmma", "rmsnorm_bwd": "simt",
               "moe_gemm_dgrad": "wgmma", "moe_gemm_wgrad": "wgmma"}
# backward kernels against their plain backward (same inputs, same lse) and
# against autograd of the plain forward: fp32 and bf16 relative to each
# gradient's largest magnitude (sums over many keys or rows; in bf16 the
# kernel rounds P for dV and each gradient once, as the plain backward does)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the training phase: full-width llama3.1-8b, 8 of 32 layers, B 2 x S 4096
TRAIN = dict(arch="llama3.1-8b", layers=8, batch=2, seq=4096, steps=10,
             lr=1e-3)
# the MoE training phase (5c): full-width deepseek-v3-16b, 5 of 28 layers
# (layer 0 dense, 4 MoE: 2.855 B fp32 params, about phase 5's), B 2 x S 4096
TRAIN_MOE = dict(arch="deepseek-v3-16b", layers=5, batch=2, seq=4096,
                 steps=10, lr=1e-3)
# phase 5m: mistral-7b, the paper's second workload (Table II), full width
# cut to 12 of 32 layers (2.879 B fp32 params, about phase 5's), B 1 x S
# 8192, so that its 4,096-token sliding window binds in every layer
TRAIN_MISTRAL = dict(arch="mistral-7b", layers=12, batch=1, seq=8192,
                     steps=10, lr=1e-3)
# phase 5x: a training smoke of each other dense arch of the registry, full
# width, 2 layers, B 1 x S 4096, 3 steps
TRAIN_DENSE = [dict(arch=a, layers=2, batch=1, seq=4096, steps=3, lr=1e-3)
               for a in ("deepseek-7b", "qwen2.5-32b", "nemotron-4-15b")]
# phase 3m: mistral-7b served past its window: a prompt of 4,608 tokens,
# longer than the 4,096-token window, so the prompt itself wraps the ring
MISTRAL_PROMPT = 4608
# phase 3d: the other dense archs, served at phase 3's settings
SERVED_DENSE = ("deepseek-7b", "qwen2.5-32b", "nemotron-4-15b")
# the runs whose every flash launch applies a window that binds (mistral's
# 4,096 over 4,608 and 8,192 positions): the windowed rows of the kernels
# line count their launches
WINDOWED_RUNS = ("mistral-7b", "mistral-7b train")
# phase 2's windowed flash rows: phase 5m's attention, B 1, S 8192, 32/8
# heads, D 128, bf16, causal with the window 4096
WINDOW_SHAPE = dict(B=1, S=8192, H=32, kvH=8, D=128, window=4096)
# ... held row by row as well (each head's D values at one position): the
# largest |kernel - plain| / |plain| of a row.  The max-abs TOL alone cannot
# tell the window's edge moved by a 64-key tile (about 1e-2 at the worst of
# 33 M outputs) from bf16 rounding (3.9e-3).  By rows, rounding stays near
# 2**-8 (the two sides round each value once, and P once), while a tile
# more or less moves a row whose window binds by about 64/4096 of its mass
# times |v| over |o| (sqrt(4096 / 64)): ~0.1.  The controls, the same
# kernels with the window WINDOW_SHIFT keys narrower and wider, held against
# the plain version at the true window, must fail this limit.
WINDOW_ROW_TOL = 2e-2
WINDOW_SHIFT = 64
# phase 5b's MoE run at a world of 1: its losses equal phase 5c's first
# steps bit for bit (at a world of 1 the MoE layers route as one device)
FSDP_MOE_STEPS_WORLD1 = 4
# kernel path vs plain path, loss and every gradient leaf of a 2-layer
# full-width bf16 cut: both round activations to bf16 at the same points
# and sum in another order, so values on a rounding boundary move one bf16
# step (2**-8 relative) and such flips compound through 2 layers and the
# backward: the mean as E2E_TOL's for the logits of the same cut (2% of
# unit-scale values; the forward alone differs by 0.76% there), the largest
# difference to 5% of a leaf's largest gradient; a detached kernel output
# would leave a leaf's gradient 100% off
TRAIN_TOL = {"loss": 1e-2, "max_rel": 5e-2, "mean_rel": 2e-2}
# the FSDP phase at a world of 1 against phase 5 (unsharded, same seed,
# batches and steps): the gathers and reduce-scatters copy, and the loss,
# the norm and AdamW take the same sums in the same order, so the losses
# should be equal; 1e-3 of the loss allows for bf16 roundings that flip
# where an operand lies in other memory (a cuBLAS choice), which AdamW's
# sign-like first steps carry into every later loss
FSDP_LOSS_TOL = 1e-3
FSDP_TIMEOUT_S = 600
# phase 5e: steps of int8 compression, unsharded and through FSDP
INT8_STEPS = 3
# phase 5d (tensor, sequence and expert parallel over "model") against
# phase 5b at the same world and seed, each step's loss relative.  The row
# products' partial sums are rounded to bf16 on each rank before the sum
# over "model", where one device rounds the whole sum once, and the batch's
# rows and the sequence split otherwise, so values on a rounding boundary
# move one bf16 step, and AdamW's sign-like first steps carry that into
# every later loss: on four H100s the largest difference read was 8e-4
# ((1, 4) llama; 3e-4 at (2, 2)), and the limit is 5 times that.  A split
# that is wrong by a partial sum can stay inside it: the fp32 gradient
# comparisons of tests/test_torch_tensor_parallel.py are what catch one
# (PERF.md section 6)
TP_LOSS_TOL = 4e-3
TP_TIMEOUT_S = 420
# phase 7, the fleet simulator, at the cluster/* scenarios' settings
# (src/repro/api/registry.py:81-120): llama3.1-8b cut to 8 layers, B 2 x S
# 4096 over 8 shards; SimConfig(seed=1, comm_gbps=40); mi300x nodes of 8
# devices capped at 700 W, node 0's hot device boosted 1.28; seed 5; 120
# iterations; the fleet manager's knobs (gpu-realloc, tuning from iteration
# 20).  7b's population: 64 fleets of 256 nodes (thermal seeds 5 + k), pp
# and tp at 16; 7c: 3 fleets of 4 nodes, 40 iterations
FLEET = dict(arch="llama3.1-8b", layers=8, batch=2, seq=4096, devices=8,
             sim=dict(seed=1, comm_gbps=40.0), preset="mi300x", cap_w=700.0,
             boost=1.28, seed=5, nodes=4, iterations=120, engine_steps=20,
             tune_after=20,
             manager=dict(use_case="gpu-realloc", sampling_period=2,
                          warmup=2, window_size=2, node_window_size=2,
                          power_cap=700.0),
             pop_samples=64, pop_nodes=256, topo_samples=16, stat_samples=3,
             stat_iterations=40)
# the window scan against its plain version: both round every float64
# operation on its own, in the same order (the kernel's _rn intrinsics are
# never contracted into FMAs), so they should agree to the bit
SCAN_RTOL = 1e-12
# engine torch against engine vector, the JAX package's limits for its
# engine against the vector engine (tests/test_jax_engine.py:54-62), and
# the scan's tail means against ClusterSim's (tests/test_jax_engine.py:115)
ENGINE_RTOL, ENGINE_ATOL = 1e-9, 1e-12
STAT_REL = 5e-3
# the redesigned kernels' times before their wgmma redesign, by this script
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), at the shapes of phase 2:
# printed in the log beside this run's times, never in the kernels line
PREV_MS = {"flash_attention": {"ms": 0.5279},
           "moe_gemm": {"ms": 0.4996, "decode_ms": 0.1501},
           "flash_attention_bwd": {"ms": 52.82}}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_FLUSH = None


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, L2 flushed before each launch.

    The flush (256 MB written, ~0.1 ms) outlasts the host's enqueue of a
    small fn, so the host runs ahead and host gaps stay out of the events.
    """
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        _FLUSH.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


SENTINELS = 16     # kernels launched around the timed ones, then left out


def profiled_kernels(calls):
    """The CUDA kernel records (key_averages) of one torch.profiler session
    (CPU and CUDA traced) around ``calls()``, with SENTINELS spin kernels
    before and after it that are left out: a session may lose the records of
    its first or last kernels (after the training phase every session lost
    its first two), and then loses the sentinels' instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spin()
        calls()
        spin()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin" not in e.key]


def device_ms(fn, iters: int = 20, kernels: int = 1, flush: bool = True):
    """Device time in ms of the kernels one call of fn() launches
    (torch.profiler): the kernels alone, without the gaps around a launch
    that cuda_ms's events also hold.  ``flush``: L2 flushed before each call
    (the flush's own fill kernels left out); ``kernels``: how many one call
    launches (0: any whole number a call).  A profiler session now and then
    drops kernel records: one that did not record that many, each with its
    time, is run again; after three such sessions the time is not measured
    (None)."""
    if flush:
        cuda_ms(fn, iters=1)                      # warm, and the flush made
    else:
        fn()
        torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            if flush:
                _FLUSH.zero_()
            fn()
    for _ in range(3):
        ev = [e for e in profiled_kernels(calls)
              if not (flush and "fill" in e.key.lower())]
        n = sum(e.count for e in ev)
        if n and n % iters == 0 and (not kernels or n == kernels * iters) \
                and all(e.self_device_time_total > 0 for e in ev):
            return sum(e.self_device_time_total for e in ev) / iters / 1e3
        log(f"  profiler recorded {[(e.key[:40], e.count) for e in ev][:4]}"
            f" ({n} kernels) for {iters} calls")
    log("  device time not measured: the profiler dropped kernels in 3 "
        "sessions")
    return None


def host_us(fn, iters: int = 50, repeats: int = 5) -> float:
    """Host time of one call of fn in us, the least over ``repeats`` runs of
    ``iters`` calls: the Python around a launch and the launch itself.  The
    calls queue on the device (fewer than its launch queue holds), so the
    host never waits for the device inside a run."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / iters * 1e6


def took(fn, call):
    """call() and the path of ``fn`` (a wrapper with ``launches_by_path``)
    that it launched."""
    before = dict(fn.launches_by_path)
    out = call()
    paths = [k for k, n in fn.launches_by_path.items() if n != before[k]]
    return out, "/".join(paths)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def check_close(name: str, a, b, atol: float, rtol: float) -> float:
    """|a - b| <= atol + rtol |b| everywhere; returns the max abs error."""
    diff = (a.float() - b.float()).abs()
    excess = float((diff - atol - rtol * b.float().abs()).max())
    err = float(diff.max())
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:.3g}, rtol {rtol:g}) "
        f"{'ok' if excess <= 0 else 'FAILED'}")
    if excess > 0:
        raise AssertionError(f"{name}: error above atol {atol} + rtol {rtol}")
    return err


# --------------------------------------------------------------------------- #
# Phase 1: card and build
# --------------------------------------------------------------------------- #
CARD = ""          # "name, power limit" as nvidia-smi gives them


def card() -> None:
    global CARD
    for query in ("name,power.limit",
                  "name,power.limit,clocks.sm,temperature.gpu,power.draw"):
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        log(out.splitlines()[0])
        CARD = CARD or out.splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "moe_gemm", "moe_gemm_bwd", "wkv6", "c3_window"):
        _build.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    for entry in _build.build_log:
        for line in entry.splitlines():
            if line.startswith("==") or "Used" in line or "spill" in line:
                log("  " + line.strip())
            elif "Compiling entry function" in line:   # the kernel, briefly
                log("  " + line.split("'")[1].split("_cu_")[-1][:70])
            elif "C75" in line:       # ptxas: wgmma serialized, and why
                fn = line.split("function '")[-1].split("'")[0]
                log("  " + line.strip()[:130] + " ["
                    + fn.split("_cu_")[-1][:60] + "]")


# --------------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def flash_checks(g) -> dict:
    dev = "cuda"
    log("flash attention (kernel vs plain):")
    cases = [  # (B, Sq, Sk, H, kvH, D, dtype, causal, window, q_offset, mask)
        (4, 200, 200, 8, 2, 64, torch.float32, True, 0, 0, False),
        (2, 200, 200, 8, 2, 64, torch.bfloat16, True, 32, 0, False),
        (2, 131, 131, 4, 4, 128, torch.float32, False, 0, 0, False),
        (2, 96, 96, 4, 2, 32, torch.bfloat16, False, 0, 0, True),
        (1, 77, 77, 4, 1, 16, torch.float32, True, 16, 0, True),
        (2, 65, 193, 8, 2, 128, torch.bfloat16, True, 0, 128, False),
        (2, 130, 130, 4, 4, 128, torch.bfloat16, False, 0, 0, True),
        (1, 777, 777, 8, 1, 128, torch.bfloat16, True, 0, 0, False),
        # qwen2.5-32b's group of 5, nemotron-4-15b's of 6
        (1, 300, 300, 40, 8, 128, torch.bfloat16, True, 0, 0, False),
        (1, 300, 300, 48, 8, 128, torch.bfloat16, True, 64, 0, False),
    ]
    for B, Sq, Sk, H, kvH, D, dt, causal, window, off, use_mask in cases:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, kvH, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, kvH, D, generator=g, device=dev).to(dt)
        mask = None
        if use_mask:
            mask = torch.rand(Sq, Sk, generator=g, device=dev) < 0.6
            mask[:, :min(Sq, Sk)] |= torch.eye(min(Sq, Sk), dtype=torch.bool,
                                              device=dev)
        kw = dict(causal=causal, window=window, q_offset=off)
        out, path = took(flash_attention_fwd,
                         lambda: flash_attention_fwd(q, k, v, mask, **kw))
        err = max_err(out, flash_attention_ref(q, k, v, mask, **kw))
        check(f"B{B} Sq{Sq} Sk{Sk} H{H}/{kvH} D{D} {str(dt)[6:]} "
              f"causal={causal} window={window} q_offset={off} "
              f"mask={use_mask} [{path}]", err, TOL[dt])

    # the serving prefill shape: B 4, S 512, H 32/8, D 128, bf16, causal
    B, S, H, kvH, D, dt = 4, 512, 32, 8, 128, torch.bfloat16
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
    out, path = took(flash_attention_fwd,
                     lambda: flash_attention_fwd(q, k, v, causal=True))
    err = max_err(out, flash_attention_ref(q, k, v, causal=True))
    check(f"main shape B{B} S{S} H{H}/{kvH} D{D} bf16 causal [{path}]", err,
          TOL[dt])
    if path != "wgmma":
        raise AssertionError(f"main shape took the {path} kernel")
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                       iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    log(f"  library sdpa vs kernel: max_abs_err "
        f"{max_err(lib_out.transpose(1, 2), flash_attention_fwd(q, k, v, causal=True)):.3e}")
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())     # q,k,v in, o out
    pairs = S * (S + 1) // 2                                  # causal (q,k)
    flops = 4 * B * H * D * pairs
    b_ms, b_by = bound(nbytes, flops, dt)
    log(f"  main shape: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x sdpa; before "
        f"the redesign {PREV_MS['flash_attention']['ms']} ms in PERF.md), "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {CARD}")
    # the explicit-mask form (the TPU's _fa_kernel_masked) at the same shape
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril_()
    m_err = max_err(flash_attention_fwd(q, k, v, mask),
                    flash_attention_ref(q, k, v, mask))
    check("main shape, causal mask as a tensor", m_err, TOL[dt])
    m_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask))
    m_plain = cuda_ms(lambda: flash_attention_ref(q, k, v, mask), iters=5)
    m_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    m_bound, m_by = bound(nbytes + mask.numel(),
                          4 * B * H * D * int(mask.sum()), dt)
    log(f"  mask form: kernel {m_ms:.4f} ms, plain {m_plain:.4f} ms, sdpa "
        f"{m_lib:.4f} ms, bound {m_bound * 1e3:.2f} us ({m_by})")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:105",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, mask_ms=m_ms,
                mask_plain_ms=m_plain, mask_bound_ms=m_bound,
                mask_library_ms=m_lib)


def rmsnorm_checks(g) -> dict:
    dev = "cuda"
    log("rmsnorm (kernel vs plain):")

    def offset(rows, d, dt, elems):
        """A contiguous (rows, d) tensor whose storage starts ``elems``
        elements past a 16-byte boundary."""
        t = torch.randn(rows * d + elems, generator=g, device=dev).to(dt)
        return t[elems:].view(rows, d)

    cases = [  # (x, w dtype, residual, the path it must take)
        (lambda: torch.randn(4, 4096, generator=g, device=dev).bfloat16(),
         torch.float32, False, "vector"),                       # decode
        (lambda: torch.randn(2048, 4096, generator=g, device=dev).bfloat16(),
         torch.float32, True, "vector"),                        # residual form
        (lambda: torch.randn(4096, 128, generator=g, device=dev).bfloat16(),
         torch.float32, False, "simt"),                         # qk-norm width
        (lambda: torch.randn(1, 4096, generator=g, device=dev).bfloat16(),
         torch.bfloat16, True, "vector"),                       # 1 row
        (lambda: torch.randn(37, 2560, generator=g, device=dev),
         torch.float32, True, "vector"),
        (lambda: torch.randn(5, 8192, generator=g, device=dev),
         torch.bfloat16, True, "vector"),                       # 512 threads
        (lambda: torch.randn(9, 1000, generator=g, device=dev),
         torch.bfloat16, False, "simt"),                        # a warp a row
        (lambda: torch.randn(6, 1032, generator=g, device=dev).bfloat16(),
         torch.bfloat16, False, "vector"),                      # just wider
        (lambda: torch.randn(9, 1500, generator=g, device=dev).bfloat16(),
         torch.float32, True, "simt"),                          # 3000 B rows
        (lambda: torch.randn(7, 100, generator=g, device=dev),
         torch.float32, False, "simt"),
        (lambda: offset(33, 4096, torch.bfloat16, 1),
         torch.float32, True, "simt"),                          # unaligned
        (lambda: torch.randn(3, 20000, generator=g, device=dev).bfloat16(),
         torch.float32, False, "simt"),                         # over 32 KB
    ]
    for make, wdt, res, want in cases:
        x = make()
        rows, d = x.shape
        dt = x.dtype
        w = torch.randn(d, generator=g, device=dev).to(wdt)
        if res:
            r = offset(rows, d, dt, 0) if x.data_ptr() % 16 == 0 else \
                offset(rows, d, dt, 1)
            (y, s), path = took(rmsnorm_fwd, lambda: rmsnorm_fwd(x, w, r))
            y_ref, s_ref = rmsnorm_ref(x, w, r)
            err = max(max_err(y, y_ref), max_err(s, s_ref))
        else:
            y, path = took(rmsnorm_fwd, lambda: rmsnorm_fwd(x, w))
            err = max_err(y, rmsnorm_ref(x, w))
        check(f"rows {rows} d {d} x {str(dt)[6:]} w {str(wdt)[6:]} "
              f"residual={res} base+{x.data_ptr() % 16}B [{path}]", err,
              TOL[dt])
        if path != want:
            raise AssertionError(f"rows {rows} d {d}: took {path}, not {want}")

    # the serving prefill shape: 2048 rows of 4096, bf16, fp32 weight
    x = torch.randn(2048, 4096, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(4096, generator=g, device=dev)
    y, path = took(rmsnorm_fwd, lambda: rmsnorm_fwd(x, w))
    err = max_err(y, rmsnorm_ref(x, w))
    check(f"main shape 2048x4096 bf16 [{path}]", err, TOL[torch.bfloat16])
    if path != "vector":
        raise AssertionError(f"main shape took the {path} kernel")
    ms = cuda_ms(lambda: rmsnorm_fwd(x, w))
    simt_ms = cuda_ms(lambda: rms_kernel._launch("simt", x, w))
    plain_ms = cuda_ms(lambda: rmsnorm_ref(x, w))
    wl = w.to(x.dtype)
    lib_ms = cuda_ms(lambda: F.rms_norm(x, (4096,), wl, 1e-5))
    nbytes = 2 * x.numel() * 2 + w.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * x.numel(), torch.bfloat16)
    log(f"  main shape: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x F.rms_norm), "
        f"scalar kernel {simt_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}: {nbytes / 1e6:.1f} MB); {CARD}")
    # the decode shape: 4 rows of 4096
    xd = x[:4].clone()
    dec_ms = cuda_ms(lambda: rmsnorm_fwd(xd, w))
    dec_simt = cuda_ms(lambda: rms_kernel._launch("simt", xd, w))
    dec_plain = cuda_ms(lambda: rmsnorm_ref(xd, w))
    dec_lib = cuda_ms(lambda: F.rms_norm(xd, (4096,), wl, 1e-5))
    dec_bound, dec_by = bound(2 * xd.numel() * 2 + w.numel() * 4,
                              4 * xd.numel(), torch.bfloat16)
    log(f"  decode shape 4x4096: kernel {dec_ms:.4f} ms, scalar kernel "
        f"{dec_simt:.4f} ms, plain "
        f"{dec_plain:.4f} ms, F.rms_norm {dec_lib:.4f} ms, bound "
        f"{dec_bound * 1e3:.3f} us ({dec_by})")
    # the residual form (the TPU's _rms_res_kernel) at the main shape
    r = torch.randn(2048, 4096, generator=g, device=dev).to(torch.bfloat16)
    (_, _), r_path = took(rmsnorm_fwd, lambda: rmsnorm_fwd(x, w, r))
    r_ms = cuda_ms(lambda: rmsnorm_fwd(x, w, r))
    r_simt = cuda_ms(lambda: rms_kernel._launch("simt", x, w, r))
    r_plain = cuda_ms(lambda: rmsnorm_ref(x, w, r))
    r_bound, r_by = bound(4 * x.numel() * 2 + w.numel() * 4, 5 * x.numel(),
                          torch.bfloat16)
    log(f"  residual form: kernel {r_ms:.4f} ms [{r_path}], scalar kernel "
        f"{r_simt:.4f} ms, plain "
        f"{r_plain:.4f} ms, no library call, bound {r_bound * 1e3:.2f} us "
        f"({r_by})")
    row = dict(name="rmsnorm", route="cuda",
               source="src/repro_torch/kernels/csrc/rmsnorm.cu",
               replaces="src/repro/kernels/rmsnorm/kernel.py:34",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, decode_ms=dec_ms,
               decode_plain_ms=dec_plain, decode_bound_ms=dec_bound,
               decode_bound_by=dec_by, decode_library_ms=dec_lib,
               residual_ms=r_ms, residual_plain_ms=r_plain,
               residual_bound_ms=r_bound, residual_library_ms=None,
               simt_ms=simt_ms, decode_simt_ms=dec_simt,
               residual_simt_ms=r_simt)
    return row


def moe_gemm_checks(g) -> dict:
    dev = "cuda"
    log("moe_gemm (kernel vs plain):")
    cases = [  # (E, C, d, h, dtype): ragged C, d, h; E = 1; C = 8
        (4, 64, 96, 200, torch.float32),
        (3, 37, 100, 45, torch.float32),
        (3, 37, 100, 45, torch.bfloat16),       # element-wise loads (wmma)
        (2, 130, 72, 136, torch.bfloat16),      # one 256-row C-tile
        (2, 240, 40, 24, torch.bfloat16),
        (1, 8, 2048, 1408, torch.bfloat16),     # E 1, C 8
        (3, 9, 72, 136, torch.bfloat16),        # C padded to 16
        (3, 65, 200, 72, torch.bfloat16),       # one 128-row C-tile
        (8, 8, 16, 16, torch.float32),
        (64, 8, 1408, 2048, torch.bfloat16),    # decode, the wd form
        (64, 240, 1408, 2048, torch.bfloat16),  # prefill, the wd form
    ]
    for E, C, d, h, dt in cases:
        x = torch.randn(E, C, d, generator=g, device=dev).to(dt)
        w = torch.randn(E, d, h, generator=g, device=dev).to(dt)
        y, path = took(moe_gemm_fwd, lambda: moe_gemm_fwd(x, w))
        check_close(f"E{E} C{C} d{d} h{h} {str(dt)[6:]} [{path}]", y,
                    moe_gemm_ref(x, w), TOL[dt] * d ** 0.5, TOL[dt])

    # the serving shapes of wg / wu: prefill C 240 (T 2048), decode C 8 (T 4)
    row = None
    for what, C in (("prefill", 240), ("decode", 8)):
        E, d, h, dt = 64, 2048, 1408, torch.bfloat16
        x = torch.randn(E, C, d, generator=g, device=dev).to(dt)
        w = torch.randn(E, d, h, generator=g, device=dev).to(dt)
        y, path = took(moe_gemm_fwd, lambda: moe_gemm_fwd(x, w))
        err = check_close(f"{what} shape ({E},{C},{d})x({E},{d},{h}) bf16 "
                          f"[{path}]", y, moe_gemm_ref(x, w),
                          TOL[dt] * d ** 0.5, TOL[dt])
        if path != "wgmma":
            raise AssertionError(f"{what} shape took the {path} kernel")
        ms = cuda_ms(lambda: moe_gemm_fwd(x, w))
        plain_ms = cuda_ms(lambda: moe_gemm_ref(x, w), iters=5)
        lib_ms = cuda_ms(lambda: torch.bmm(x, w))
        nbytes = 2 * (x.numel() + w.numel() + E * C * h)
        flops = 2 * E * C * d * h
        b_ms, b_by = bound(nbytes, flops, dt)
        prev = PREV_MS["moe_gemm"]["ms" if row is None else "decode_ms"]
        log(f"  {what} shape: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x "
            f"torch.bmm; before the redesign {prev} ms in PERF.md), plain "
            f"{plain_ms:.4f} ms, "
            f"torch.bmm {lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {CARD}")
        if row is None:
            row = dict(name="moe_gemm", route="cuda",
                       source="src/repro_torch/kernels/csrc/moe_gemm.cu",
                       replaces="src/repro/kernels/moe_gemm/kernel.py:47",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        else:
            row.update(decode_ms=ms, decode_plain_ms=plain_ms,
                       decode_bound_ms=b_ms, decode_library_ms=lib_ms)
    return row


def host_costs(g) -> dict:
    """Host us per call of each kernel as the models call it (``ops``), and
    of flash's and the GEMM's library calls: flash and the GEMM at phase 2's
    main shapes, RMSNorm and WKV6 at their decode shapes (where the host, not
    the kernel, sets a step's time).  It uses only what every version of the
    port has, so that ``--host-only`` can time an older checkout's wrappers
    the same way."""
    dev, dt = "cuda", torch.bfloat16
    q = torch.randn(4, 512, 32, 128, generator=g, device=dev).to(dt)
    k, v = (torch.randn(4, 512, 8, 128, generator=g, device=dev).to(dt)
            for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash = dict(
        host_us=host_us(lambda: fa_ops.flash_attention(q, k, v, causal=True)),
        library_host_us=host_us(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))
    moe = {}
    w = torch.randn(64, 2048, 1408, generator=g, device=dev).to(dt)
    for pre, C in (("", 240), ("decode_", 8)):
        x = torch.randn(64, C, 2048, generator=g, device=dev).to(dt)
        moe[pre + "host_us"] = host_us(lambda: moe_ops.moe_gemm(x, w))
        moe[pre + "library_host_us"] = host_us(lambda: torch.bmm(x, w))
    xd = torch.randn(4, 4096, generator=g, device=dev).to(dt)
    wd = torch.randn(4096, generator=g, device=dev)
    rms = dict(decode_host_us=host_us(lambda: rms_ops.rmsnorm(xd, wd)))
    r1, k1, v1 = (torch.randn(4, 1, 40, 64, generator=g, device=dev).to(dt)
                  for _ in range(3))
    w1 = -torch.exp(torch.randn(4, 1, 40, 64, generator=g, device=dev))
    u1 = torch.randn(40, 64, generator=g, device=dev)
    s1 = torch.randn(4, 40, 64, 64, generator=g, device=dev)
    wkv = dict(decode_host_us=host_us(
        lambda: wkv_ops.wkv6(r1, k1, v1, w1, u1, s1)))
    log(f"host us per call: flash {flash['host_us']:.2f} (sdpa "
        f"{flash['library_host_us']:.2f}); grouped GEMM prefill "
        f"{moe['host_us']:.2f} (torch.bmm {moe['library_host_us']:.2f}), "
        f"decode {moe['decode_host_us']:.2f} (torch.bmm "
        f"{moe['decode_library_host_us']:.2f}); decode RMSNorm "
        f"{rms['decode_host_us']:.2f}, WKV6 {wkv['decode_host_us']:.2f}; "
        f"{CARD}")
    return {"flash_attention": flash, "moe_gemm": moe, "rmsnorm": rms,
            "wkv6": wkv}


def wkv_inputs(g, B, S, H, D, dt, state):
    """As tests/test_kernels.py draws them: r, k, v ~ 0.5 N(0,1), w_log =
    -exp(N(0,1)) fp32, u ~ N(0,1); a state ~ 0.5 N(0,1)."""
    r, k, v = (0.5 * torch.randn(B, S, H, D, generator=g, device="cuda")
               for _ in range(3))
    w = -torch.exp(torch.randn(B, S, H, D, generator=g, device="cuda"))
    u = torch.randn(H, D, generator=g, device="cuda")
    s0 = (0.5 * torch.randn(B, H, D, D, generator=g, device="cuda")
          if state else None)
    return r.to(dt), k.to(dt), v.to(dt), w, u, s0


def wkv6_checks(g) -> dict:
    log("wkv6 (kernel vs plain):")

    def inputs(B, S, H, D, dt, state):
        return wkv_inputs(g, B, S, H, D, dt, state)

    def check_wkv(name, args) -> tuple:
        """y against atol + rtol |y_ref|, the fp32 state against atol;
        returns the larger error and the path the kernel took."""
        atol, rtol = WKV_TOL[args[0].dtype]
        (y, s), path = took(wkv6_fwd, lambda: wkv6_fwd(*args))
        y_ref, s_ref = wkv6_ref(*args)
        err = check_close(f"{name} [{path}], y", y, y_ref, atol, rtol)
        s_err = max_err(s, s_ref)
        check(f"{name} [{path}], state", s_err, atol)
        return max(err, s_err), path

    # every head size, dtype and initial state at S 1, 17, 130 (a partial
    # last chunk) and 512, each at H 3 and 5
    for S in (1, 17, 130, 512):
        for D in (16, 32, 64):
            for dt in (torch.float32, torch.bfloat16):
                for state in (False, True):
                    for B, H in ((2, 3), (3, 5)):
                        _, path = check_wkv(
                            f"B{B} S{S} H{H} D{D} {str(dt)[6:]} "
                            f"state={state}", inputs(B, S, H, D, dt, state))
                        if path != "split":
                            raise AssertionError(f"took the {path} kernel")
    # a base off the 16-byte grid: the one-column-a-thread kernel
    r, k, v, w, u, s0 = inputs(2, 77, 5, 64, torch.bfloat16, True)
    r = torch.cat([r.new_zeros(1), r.flatten()])[1:].view(r.shape)
    _, path = check_wkv("B2 S77 H5 D64 bf16 state=True, r unaligned",
                        (r, k, v, w, u, s0))
    if path != "simt":
        raise AssertionError(f"unaligned r took the {path} kernel, not simt")

    # the serving shapes: prefill from zero state, decode from a state
    row = None
    for what, S, state in (("prefill", 512, False), ("decode", 1, True)):
        B, H, D, dt = 4, 40, 64, torch.bfloat16
        args = inputs(B, S, H, D, dt, state)
        err, path = check_wkv(f"{what} shape B{B} S{S} H{H} D{D} bf16 "
                              f"state={state}", args)
        if path != "split":
            raise AssertionError(f"{what} shape took the {path} kernel")
        ms = cuda_ms(lambda: wkv6_fwd(*args))
        simt_ms = cuda_ms(lambda: wkv_kernel._launch("simt", *args))
        plain_ms = cuda_ms(lambda: wkv6_ref(*args), iters=5)
        n = B * S * H * D
        # r, k, v and y in bf16, w_log fp32, u, the state in (if given) and
        # out; 5 fp32 operations per (t, d, e): y's multiply-add, the decay
        # multiply, the k v product and its add
        nbytes = (4 * n * 2 + n * 4 + H * D * 4
                  + (1 + state) * B * H * D * D * 4)
        flops = 5 * n * D
        b_ms, b_by = bound(nbytes, flops, torch.float32)
        log(f"  {what} shape: kernel {ms:.4f} ms, one-column-a-thread kernel "
            f"{simt_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"no library call, bound {b_ms * 1e3:.2f} us ({b_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); {CARD}")
        if row is None:
            row = dict(name="wkv6", route="cuda",
                       source="src/repro_torch/kernels/csrc/wkv6.cu",
                       replaces="src/repro/kernels/rwkv6_wkv/kernel.py:68",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       simt_ms=simt_ms)
        else:
            row.update(decode_max_abs_err=err, decode_ms=ms,
                       decode_plain_ms=plain_ms, decode_bound_ms=b_ms,
                       decode_bound_by=b_by, decode_library_ms=None,
                       decode_simt_ms=simt_ms)
    return row


def row_err(a, b) -> float:
    """The largest over rows (the last axis) of |a - b| over the larger of
    |b| and the RMS of b's row norms: a row that is zero by construction
    (dq where a query sees a single key) holds only rounding noise."""
    a, b = a.float(), b.float()
    norms = b.norm(dim=-1)
    floor = float(norms.square().mean().sqrt())
    return float(((a - b).norm(dim=-1) / norms.clamp_min(floor)).max())


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def check_grads(name: str, got, plain, auto, tol: float) -> float:
    """Each gradient against the plain backward's and autograd's, relative
    to its largest magnitude; returns the largest error."""
    worst = 0.0
    for n, a, b, c in zip("qkv" if len(got) == 3 else "xw", got, plain, auto):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: d{n} {a.dtype} {tuple(a.shape)}, "
                                 f"plain {b.dtype} {tuple(b.shape)}")
        worst = max(worst, rel_err(a, b), rel_err(a, c))
    log(f"  {name}: max rel_err {worst:.3e} (tol {tol:g}) "
        f"{'ok' if worst <= tol else 'FAILED'}")
    if worst > tol:
        raise AssertionError(f"{name}: gradient error {worst} above {tol}")
    return worst


def autograd_of(fn, inputs, dout):
    """Gradients of sum(fn(*inputs) * dout) by autograd, on fp32 copies."""
    leaves = [t.detach().float().requires_grad_() for t in inputs]
    fn(*leaves).backward(dout.float())
    return [t.grad for t in leaves]


def flash_bwd_checks(g) -> dict:
    dev = "cuda"
    log("flash attention backward (kernel vs plain backward and autograd):")
    cases = [  # (B, Sq, Sk, H, kvH, D, dtype, causal, window, q_offset)
        (2, 200, 200, 8, 8, 16, torch.float32, True, 0, 0),
        (2, 200, 200, 8, 2, 64, torch.bfloat16, True, 32, 0),
        (1, 300, 300, 16, 2, 128, torch.bfloat16, True, 0, 0),
        (2, 131, 131, 4, 4, 128, torch.float32, False, 0, 0),
        (2, 65, 193, 8, 2, 64, torch.float32, True, 48, 128),
        (1, 96, 96, 8, 1, 32, torch.bfloat16, False, 40, 0),
        (2, 77, 77, 8, 1, 16, torch.bfloat16, True, 16, 0),
        (2, 257, 257, 32, 8, 128, torch.bfloat16, True, 0, 0),
        (1, 300, 300, 40, 8, 128, torch.bfloat16, True, 0, 0),     # group 5
        (1, 300, 300, 48, 8, 128, torch.bfloat16, True, 64, 0),    # group 6
    ]
    for B, Sq, Sk, H, kvH, D, dt, causal, window, off in cases:
        q, do = (torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Sk, kvH, D, generator=g, device=dev).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=off)
        o, lse = flash_attention_fwd(q, k, v, **kw, return_lse=True)
        _, lse_ref = flash_attention_ref(q, k, v, **kw, return_lse=True)
        lse_err = max_err(lse, lse_ref)
        grads, path = took(flash_attention_bwd, lambda: flash_attention_bwd(
            q, k, v, o, lse, do, **kw))
        want = "wgmma" if dt == torch.bfloat16 and D in (64, 128) else "simt"
        if path != want:
            raise AssertionError(f"flash backward took {path}, not {want}")
        check_grads(f"B{B} Sq{Sq} Sk{Sk} H{H}/{kvH} D{D} {str(dt)[6:]} "
                    f"causal={causal} window={window} q_offset={off} [{path}]"
                    f" (lse max_abs_err {lse_err:.1e})", grads,
                    flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
                    autograd_of(lambda a, b, c: flash_attention_ref(
                        a, b, c, **kw), (q, k, v), do), BWD_TOL[dt])
        if lse_err > 1e-4:
            raise AssertionError(f"lse error {lse_err}")

    # the training shape: B 2, S 4096, H 32/8, D 128, bf16, causal
    B, S, H, kvH, D, dt = 2, 4096, 32, 8, 128, torch.bfloat16
    q, do = (torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    grads, path = took(flash_attention_bwd, lambda: flash_attention_bwd(
        q, k, v, o, lse, do, causal=True))
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    simt = fa_kernel._launch_bwd("simt", q, k, v, o, lse, do, causal=True,
                                 window=0, q_offset=0)
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    err = max(rel_err(a, b) for a, b in zip(grads, plain))
    simt_err = max(rel_err(a, b) for a, b in zip(simt, plain))
    log(f"  main shape B{B} S{S} H{H}/{kvH} D{D} bf16 causal [{path}]: max "
        f"rel_err {err:.3e} against the plain backward (tol "
        f"{BWD_TOL[dt]:g}), the same bits twice: {same}; the kept simt "
        f"kernels {simt_err:.3e}")
    if path != "wgmma" or err > BWD_TOL[dt] or simt_err > BWD_TOL[dt] \
            or not same:
        raise AssertionError("flash backward, main shape")
    del plain, again, simt
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=True), iters=5)
    simt_ms = cuda_ms(lambda: fa_kernel._launch_bwd(
        "simt", q, k, v, o, lse, do, causal=True, window=0, q_offset=0),
        iters=2, warmup=1)
    plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
    lib = sdpa_backward(q, k, v, do)
    lib_ms = cuda_ms(lib, iters=5)
    nbytes = 2 * (3 * q.numel() + 4 * k.numel()) + lse.numel() * 4
    flops = 5 * B * H * S * S * D          # 5 products, the causal half
    b_ms, b_by = bound(nbytes, flops, dt)
    log(f"  main shape: kernel {ms:.3f} ms ({ms / b_ms:.1f}x its bound, "
        f"{ms / lib_ms:.2f}x sdpa's backward; before the redesign "
        f"{PREV_MS['flash_attention_bwd']['ms']} ms in PERF.md), kept simt "
        f"kernels {simt_ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa backward "
        f"{lib_ms:.3f} ms, bound {b_ms * 1e3:.1f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP); {CARD}")
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/attention.py:152",
                replaces_note="no TPU kernel: XLA autodiff of sdpa_flash",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, simt_ms=simt_ms)


def library_backward(fn, q, k, v, do):
    """One autograd backward of ``fn`` (a library's attention on q, k, v
    transposed to (B, H, S, D)) for q, k, v, dO (B, S, H, D)."""
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


def sdpa_backward(q, k, v, do, mask=None):
    """One autograd backward of F.scaled_dot_product_attention (causal, or
    the boolean ``mask`` where given; GQA): the library's yardstick for
    flash's backward."""
    return library_backward(lambda *t: F.scaled_dot_product_attention(
        *t, is_causal=mask is None, attn_mask=mask, enable_gqa=True),
        q, k, v, do)


def flex_window(S: int, window: int):
    """torch's flex_attention, compiled, with a causal sliding-window
    BlockMask over S positions: a library call that skips the tiles outside
    the window, as the kernels do (sdpa with a boolean mask computes every
    pair).  It takes q, k, v as (B, H, S, D), GQA.  Inductor's and Triton's
    caches go under build/ beside this script."""
    here = Path(__file__).resolve().parent / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(here / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(here / "triton"))
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def sliding(b, h, qi, ki):
        return (ki <= qi) & (qi - ki < window)
    block = create_block_mask(sliding, None, None, S, S, device="cuda")
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: fn(q, k, v, block_mask=block, enable_gqa=True)


def window_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal window lets through over S positions:
    each query sees itself and up to window - 1 keys before it."""
    return sum(min(i + 1, window) for i in range(S))


def window_flash_checks(g) -> list:
    """The windowed flash forward and backward (the TPU's ``_fa_kernel``
    with its window) at phase 5m's attention, B 1, S 8192, 32/8 heads, D
    128, bf16, causal with the window 4096, which binds there: each against
    its plain version, by its largest error and row by row
    (WINDOW_ROW_TOL), where the same kernel with the window moved by a
    tile either way must fail; then the kernel's, the plain version's and
    the libraries' times (flex_attention with a sliding-window BlockMask,
    the row's ``library_ms``, and F.scaled_dot_product_attention with the
    window as a boolean mask, ``sdpa_mask_ms``; forward and autograd
    backward) against the bound of the pairs the window lets through."""
    dev, dt = "cuda", torch.bfloat16
    B, S, H, kvH, D, W = (WINDOW_SHAPE[k] for k in ("B", "S", "H", "kvH",
                                                     "D", "window"))
    kw = dict(causal=True, window=W)
    shifts = (-WINDOW_SHIFT, WINDOW_SHIFT)
    log(f"windowed flash attention at B{B} S{S} H{H}/{kvH} D{D} bf16 causal "
        f"window {W} (kernel vs plain):")
    q, do = (torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
            for _ in range(2))
    (o, lse), path = took(flash_attention_fwd, lambda: flash_attention_fwd(
        q, k, v, **kw, return_lse=True))
    ref = flash_attention_ref(q, k, v, **kw)
    err = max_err(o, ref)
    check(f"forward [{path}]", err, TOL[dt])
    rows = row_err(o, ref)
    moved = {W + d: row_err(flash_attention_fwd(q, k, v, causal=True,
                                                window=W + d), ref)
             for d in shifts}
    del ref
    log(f"  forward by rows: max |o - plain| / |plain| {rows:.3e} (tol "
        f"{WINDOW_ROW_TOL:g}); the kernel at windows {list(moved)} against "
        f"the plain version at {W} (controls, must exceed the tol): "
        f"{ {w: f'{e:.3e}' for w, e in moved.items()} }")
    grads, bpath = took(flash_attention_bwd, lambda: flash_attention_bwd(
        q, k, v, o, lse, do, **kw))
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    berr = max(rel_err(a, b) for a, b in zip(grads, plain))
    brows = max(row_err(a, b) for a, b in zip(grads, plain))
    bmoved = {W + d: max(row_err(a, b) for a, b in zip(flash_attention_bwd(
        q, k, v, o, lse, do, causal=True, window=W + d), plain))
        for d in shifts}
    log(f"  backward [{bpath}]: max rel_err {berr:.3e} against the plain "
        f"backward (tol {BWD_TOL[dt]:g}); by rows of dq, dk, dv {brows:.3e} "
        f"(tol {WINDOW_ROW_TOL:g}); at windows {list(bmoved)} (controls): "
        f"{ {w: f'{e:.3e}' for w, e in bmoved.items()} }")
    if path != "wgmma" or bpath != "wgmma" or berr > BWD_TOL[dt] \
            or max(rows, brows) > WINDOW_ROW_TOL:
        raise AssertionError("windowed flash attention")
    if min(*moved.values(), *bmoved.values()) <= WINDOW_ROW_TOL:
        raise AssertionError("windowed flash attention: a window moved by "
                             f"{WINDOW_SHIFT} keys passes the row check")
    del plain, grads
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril_()
    mask &= ~torch.ones(S, S, dtype=torch.bool, device=dev).tril_(-W)
    pairs = window_pairs(S, W)
    if int(mask.sum()) != pairs:
        raise AssertionError("the window's mask")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flex = flex_window(S, W)
    lib_err = max_err(flex(qt, kt, vt).transpose(1, 2), o)
    sdpa_err = max_err(F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2), o)
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters=10)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), iters=3,
                       warmup=1)
    lib_ms = cuda_ms(lambda: flex(qt, kt, vt), iters=10)
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=10)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())    # q,k,v in, o out
    b_ms, b_by = bound(nbytes, 4 * B * H * D * pairs, dt)
    log(f"  forward: kernel {ms:.4f} ms ({ms / b_ms:.2f}x its bound, "
        f"{ms / lib_ms:.2f}x flex_attention with the window's BlockMask, "
        f"{ms / sdpa_ms:.2f}x sdpa with the mask; max_abs_err vs the kernel: "
        f"flex {lib_err:.3e}, sdpa {sdpa_err:.3e}), plain {plain_ms:.4f} "
        f"ms, flex {lib_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound "
        f"{b_ms * 1e3:.1f} us ({b_by}: {nbytes / 1e6:.1f} MB, "
        f"{4 * B * H * D * pairs / 1e9:.1f} GFLOP, {pairs} pairs); {CARD}")
    bms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
                  iters=5)
    bplain_ms = cuda_ms(lambda: flash_attention_bwd_ref(
        q, k, v, o, lse, do, **kw), iters=2, warmup=1)
    blib_ms = cuda_ms(library_backward(flex, q, k, v, do), iters=5)
    bsdpa_ms = cuda_ms(sdpa_backward(q, k, v, do, mask), iters=5)
    bbytes = 2 * (3 * q.numel() + 4 * k.numel()) + lse.numel() * 4
    bb_ms, bb_by = bound(bbytes, 10 * B * H * D * pairs, dt)
    log(f"  backward: kernel {bms:.3f} ms ({bms / bb_ms:.2f}x its bound, "
        f"{bms / blib_ms:.2f}x flex_attention's backward, "
        f"{bms / bsdpa_ms:.2f}x sdpa's backward with the mask), plain "
        f"{bplain_ms:.3f} ms, flex backward {blib_ms:.3f} ms, sdpa backward "
        f"{bsdpa_ms:.3f} ms, bound {bb_ms * 1e3:.1f} us ({bb_by}: "
        f"{bbytes / 1e6:.1f} MB, {10 * B * H * D * pairs / 1e9:.1f} GFLOP); "
        f"{CARD}")
    library = "flex_attention, compiled, sliding-window BlockMask"
    return [dict(name="flash_attention_window", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:25",
                 max_abs_err=err, max_row_rel_err=rows,
                 shifted_row_rel_err=moved, ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                 library=library, sdpa_mask_ms=sdpa_ms),
            dict(name="flash_attention_bwd_window", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 replaces="src/repro/models/attention.py:152",
                 replaces_note="no TPU kernel: XLA autodiff of sdpa_flash",
                 max_abs_err=berr, max_row_rel_err=brows,
                 shifted_row_rel_err=bmoved, ms=bms, plain_ms=bplain_ms,
                 bound_ms=bb_ms, bound_by=bb_by, library_ms=blib_ms,
                 library=library, sdpa_mask_ms=bsdpa_ms)]


def rms_norm_backward(x, w, dy):
    """One autograd backward of F.rms_norm (weight in x's dtype)."""
    leaves = [x.detach().requires_grad_(),
              w.to(x.dtype).detach().requires_grad_()]
    y = F.rms_norm(leaves[0], (x.shape[-1],), leaves[1], 1e-5)
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def rmsnorm_bwd_checks(g) -> dict:
    dev = "cuda"
    log("rmsnorm backward (kernel vs plain backward and autograd):")
    cases = [  # (rows, d, x dtype, w dtype)
        (8192, 4096, torch.bfloat16, torch.float32),     # llama training
        (2 * 4096 * 32, 128, torch.bfloat16, torch.float32),   # qk-norm rows
        (64, 2560, torch.float32, torch.float32),
        (33, 16, torch.float32, torch.float32),           # reduced models
        (7, 5000, torch.bfloat16, torch.bfloat16),
        (3, 8192, torch.float32, torch.bfloat16),
    ]
    for rows, d, dt, wdt in cases:
        x, dy = (torch.randn(rows, d, generator=g, device=dev).to(dt)
                 for _ in range(2))
        w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(wdt)
        grads, path = took(rmsnorm_bwd, lambda: rmsnorm_bwd(x, w, dy))
        again = rmsnorm_bwd(x, w, dy)[1]
        leaves = [x.detach().float().requires_grad_(),
                  w.detach().float().requires_grad_()]
        rmsnorm_ref(*leaves).backward(dy.float())
        tol = max(BWD_TOL[dt], BWD_TOL[wdt])
        check_grads(f"rows {rows} d {d} x {str(dt)[6:]} w {str(wdt)[6:]} "
                    f"[{path}], dw the same bits twice: "
                    f"{torch.equal(again, grads[1])}", grads,
                    rmsnorm_bwd_ref(x, w, dy), [t.grad for t in leaves], tol)
        if not torch.equal(again, grads[1]):
            raise AssertionError("rmsnorm backward: dw differs between runs")

    x, dy = (torch.randn(8192, 4096, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    w = torch.randn(4096, generator=g, device=dev)
    err = max(rel_err(a, b) for a, b in zip(rmsnorm_bwd(x, w, dy),
                                            rmsnorm_bwd_ref(x, w, dy)))
    ms = cuda_ms(lambda: rmsnorm_bwd(x, w, dy))
    plain_ms = cuda_ms(lambda: rmsnorm_bwd_ref(x, w, dy))
    lib_ms = cuda_ms(rms_norm_backward(x, w, dy))
    nbytes = 3 * x.numel() * 2 + 2 * w.numel() * 4
    b_ms, b_by = bound(nbytes, 8 * x.numel(), torch.float32)
    log(f"  main shape 8192x4096 bf16: kernel {ms:.4f} ms ({ms / b_ms:.1f}x "
        f"its bound), plain {plain_ms:.4f} ms, F.rms_norm backward "
        f"{lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB); {CARD}")
    return dict(name="rmsnorm_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/models/common.py:79",
                replaces_note="no TPU kernel: XLA autodiff of rmsnorm",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def moe_gemm_bwd_checks(g) -> list:
    """moe_gemm_dgrad and moe_gemm_wgrad against the plain backward and
    autograd of the plain forward: edge cases (C <= 64, unaligned d or h,
    fp32), then deepseek-v3-16b's training shape (E 64, C 960: T 8192, top-6,
    capacity factor 1.25) in both orientations (wg / wu: d 2048 -> h 1408;
    wd: 1408 -> 2048), with the same bits twice and the kernel's, the plain
    version's and torch.bmm's times."""
    dev = "cuda"
    log("moe_gemm backward (dgrad, wgrad: kernel vs plain backward and "
        "autograd):")
    cases = [  # (E, C, d, h, dtype, the path both take)
        (3, 37, 100, 45, torch.float32, "simt"),
        (3, 37, 100, 45, torch.bfloat16, "simt"),    # unaligned d, h
        (2, 40, 96, 100, torch.bfloat16, "simt"),    # h not a multiple of 8
        (4, 64, 96, 200, torch.float32, "simt"),
        (2, 1, 64, 64, torch.bfloat16, "wgmma"),     # C 1
        (3, 8, 72, 136, torch.bfloat16, "wgmma"),    # C 8 (decode)
        (3, 64, 136, 72, torch.bfloat16, "wgmma"),   # C 64
        (2, 130, 72, 136, torch.bfloat16, "wgmma"),  # 256-row tile of C
        (2, 300, 264, 200, torch.bfloat16, "wgmma"),  # ragged 256-row tiles
        (1, 96, 2048, 1408, torch.bfloat16, "wgmma"),
    ]
    for E, C, d, h, dt, want in cases:
        x = torch.randn(E, C, d, generator=g, device=dev).to(dt)
        w = torch.randn(E, d, h, generator=g, device=dev).to(dt)
        dy = torch.randn(E, C, h, generator=g, device=dev).to(dt)
        dx, pd = took(moe_gemm_dgrad, lambda: moe_gemm_dgrad(dy, w))
        dw, pw = took(moe_gemm_wgrad, lambda: moe_gemm_wgrad(x, dy))
        if (pd, pw) != (want, want):
            raise AssertionError(f"E{E} C{C} d{d} h{h} {dt}: paths {pd}, "
                                 f"{pw}; expected {want}")
        check_grads(f"E{E} C{C} d{d} h{h} {str(dt)[6:]} [{pd}]", (dx, dw),
                    moe_gemm_bwd_ref(x, w, dy),
                    autograd_of(moe_gemm_ref, (x, w), dy), BWD_TOL[dt])

    rows = {}
    dt, E, C = torch.bfloat16, 64, 960
    for form, d, h in (("wg/wu", 2048, 1408), ("wd", 1408, 2048)):
        x = torch.randn(E, C, d, generator=g, device=dev).to(dt)
        w = torch.randn(E, d, h, generator=g, device=dev).to(dt)
        dy = torch.randn(E, C, h, generator=g, device=dev).to(dt)
        dx, pd = took(moe_gemm_dgrad, lambda: moe_gemm_dgrad(dy, w))
        dw, pw = took(moe_gemm_wgrad, lambda: moe_gemm_wgrad(x, dy))
        same = torch.equal(dx, moe_gemm_dgrad(dy, w)) and \
            torch.equal(dw, moe_gemm_wgrad(x, dy))
        plain = moe_gemm_bwd_ref(x, w, dy)
        check_grads(f"training shape {form} (E{E} C{C} d{d} h{h} bf16) "
                    f"[{pd}/{pw}]", (dx, dw), plain,
                    autograd_of(moe_gemm_ref, (x, w), dy), BWD_TOL[dt])
        err = max(max_err(a, b) for a, b in zip((dx, dw), plain))
        log(f"  max_abs_err against the plain backward {err:.3e} (gradients "
            f"up to {max(float(b.float().abs().max()) for b in plain):.1f}); "
            f"the same bits twice: {same}")
        if (pd, pw) != ("wgmma", "wgmma") or not same:
            raise AssertionError(f"training shape {form}: paths {pd}/{pw}, "
                                 f"same bits {same}")
        del dx, dw, plain
        flops = 2 * E * C * d * h
        timed = {   # name: (kernel, plain, torch.bmm, bytes moved)
            "moe_gemm_dgrad": (
                lambda: moe_gemm_dgrad(dy, w),
                lambda: moe_gemm_dgrad_ref(dy, w),
                lambda: torch.bmm(dy, w.transpose(1, 2)),
                2 * (dy.numel() + w.numel() + E * C * d)),
            "moe_gemm_wgrad": (
                lambda: moe_gemm_wgrad(x, dy),
                lambda: moe_gemm_wgrad_ref(x, dy),
                lambda: torch.bmm(x.transpose(1, 2), dy),
                2 * (x.numel() + dy.numel() + E * d * h)),
        }
        for name, (fn, plain, lib, nbytes) in timed.items():
            ms = cuda_ms(fn, iters=10)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            lib_ms = cuda_ms(lib, iters=10)
            b_ms, b_by = bound(nbytes, flops, dt)
            log(f"  {name} {form}: kernel {ms:.4f} ms ({ms / b_ms:.2f}x its "
                f"bound, {ms / lib_ms:.2f}x torch.bmm), plain {plain_ms:.4f}"
                f" ms, torch.bmm {lib_ms:.4f} ms, bound {b_ms * 1e3:.1f} us "
                f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP); "
                f"{CARD}")
            if name not in rows:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/moe_gemm_bwd.cu",
                    replaces="src/repro/models/moe.py:91",
                    replaces_note="no TPU kernel: XLA autodiff of the "
                                  "expert einsums",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)
            else:
                rows[name].update(wd_ms=ms, wd_plain_ms=plain_ms,
                                  wd_bound_ms=b_ms, wd_library_ms=lib_ms)
        del x, w, dy
        torch.cuda.empty_cache()
    return [rows["moe_gemm_dgrad"], rows["moe_gemm_wgrad"]]


# --------------------------------------------------------------------------- #
# Phase 2 (the C3 window scan) and phase 7: the fleet simulator
# --------------------------------------------------------------------------- #
def fleet_workload(layers: int = FLEET["layers"]):
    """The cluster scenarios' workload: an FSDP iteration of llama3.1-8b
    cut to ``layers`` layers, B 2 x S 4096, over 8 shards."""
    cfg = get_config(FLEET["arch"]).replace(n_layers=layers)
    return fsdp_llm_iteration(cfg, batch=FLEET["batch"], seq=FLEET["seq"],
                              n_shards=FLEET["devices"])


def edge_workloads() -> dict:
    """Step tables the fleet workload does not have: no collective (Km 0),
    and a window that holds no kernel (comm 0's producer is kernel 1 and
    kernel 2 waits on it) beside a comm with no producer."""
    comp = [CompKernel(f"k{i}", gflop=4e4 + 7e3 * i, gbyte=2.0 + 0.5 * i)
            for i in range(6)]
    no_comm = Workload(comp=[CompKernel(k.name, k.gflop, k.gbyte)
                             for k in comp], comm=[], name="no-comm")
    comp[2].wait_comm, comp[4].wait_comm = 0, 1
    gated = Workload(comp=comp, comm=[CommKernel("c0", 2e8, producer=1),
                                      CommKernel("c1", 1e8)], name="gated")
    return {"Km 0": no_comm, "empty window": gated}


def scan_inputs(g, wl, G: int, B: int, S: int = 1) -> tuple:
    """The window scan's inputs at the fleet's settings: B groups of G lanes
    in S samples, each lane at a clock drawn in [f_min, f_max], the kernel
    and comm noise of SimConfig's sigma, on the generator's device."""
    dev, f64 = str(g.device), torch.float64
    plan = torch_engine.window_plan(wl)
    A = workload_arrays(wl)
    p, sim = PRESETS[FLEET["preset"]], SimConfig(**FLEET["sim"])
    L = B * G
    f = p.f_min + (p.f_max - p.f_min) * torch.rand(L, generator=g, device=dev,
                                                   dtype=f64)
    rate_f = p.peak_gflops * sim.gemm_eff * (f / p.f_max)
    rm = torch.full((B,), p.hbm_gbps, dtype=f64, device=dev)
    noise = torch.exp(sim.noise * torch.randn(
        (S, plan.n_comp, L // S), generator=g, device=dev, dtype=f64))
    base = torch.as_tensor(A["cbytes"] / (sim.comm_gbps * 1e9), device=dev)
    dur = base * torch.exp(sim.noise * torch.randn(
        (B, plan.n_comm), generator=g, device=dev, dtype=f64))
    return (torch_engine._table(plan, dev), rate_f,
            rate_f / (1.0 + sim.kappa_comp), rm, rm / (1.0 + sim.kappa_mem),
            noise, torch.as_tensor(A["gflop"], device=dev),
            torch.as_tensor(A["gbyte"], device=dev), dur)


def scan_err(got, want) -> tuple:
    """(largest |got - want| / (|want| + 1e-12), largest |got - want|) over a
    scan's outputs (times in s, a ps floor where a time or an overlap is 0),
    inf where the NaN patterns differ."""
    rel = err = 0.0
    for a, b in zip(got, want):
        if not torch.equal(a.isnan(), b.isnan()):
            return float("inf"), float("inf")
        d = (a - b).nan_to_num(0.0).abs()
        if d.numel():
            err = max(err, float(d.max()))
            rel = max(rel, float((d / (b.nan_to_num(0.0).abs() + 1e-12))
                                 .max()))
    return rel, err


def c3_window_checks(g) -> dict:
    """The window scan against its plain version: emit and summary at the
    fleet's 256 nodes (one sample of phase 7b), groups of 3 and 12 (the
    shared-memory path), Km 0 and an empty window; a planted control (the
    kernel fed durations shifted by one comm must fail); then the kernel's
    and the plain version's time at the population's shape (64 samples of
    256 nodes of 8 lanes, summary mode, the launch phase 7b makes)."""
    log("c3_window (kernel vs plain, float64):")
    wl = fleet_workload()
    cases = [("256 nodes x 8", wl, 8, FLEET["pop_nodes"], "shuffle"),
             ("groups of 3", wl, 3, 101, "shared"),
             ("groups of 12", wl, 12, 40, "shared"),
             *((name, w, 8, 16, "shuffle")
               for name, w in edge_workloads().items())]
    err = 0.0
    for name, w, G, B, want in cases:
        inp = scan_inputs(g, w, G, B)
        for emit in (True, False):
            got, path = took(c3_window_scan,
                             lambda: c3_window_scan(*inp, G, emit))
            rel, e = scan_err(got, c3_window_ref(*inp, G, emit))
            err = max(err, e) if name.startswith("256") else err
            ok = rel <= SCAN_RTOL and path == want
            log(f"  {name}, {('emit' if emit else 'summary')} "
                f"[{path}]: largest relative error {rel:.3e} (rtol "
                f"{SCAN_RTOL:g}) {'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"c3_window {name}: {rel} off the plain "
                                     f"version, or took {path} for {want}")
        if name.startswith("256"):
            shifted = inp[:-1] + (inp[-1].roll(1, dims=1).contiguous(),)
            rel, _ = scan_err(c3_window_scan(*shifted, G, True),
                              c3_window_ref(*inp, G, True))
            log(f"  control, durations shifted by one comm: {rel:.3e} "
                f"{'fails, as it must' if rel > SCAN_RTOL else 'PASSES'}")
            if not rel > SCAN_RTOL:
                raise AssertionError("c3_window: the shifted control passed")
    one = scan_inputs(g, wl, 8, FLEET["pop_nodes"])
    one_ms = cuda_ms(lambda: c3_window_scan(*one, 8, False))
    S, N = FLEET["pop_samples"], FLEET["pop_nodes"]
    inp = scan_inputs(g, wl, 8, S * N, S)
    rel, e = scan_err(c3_window_scan(*inp, 8, False),
                      c3_window_ref(*inp, 8, False))
    log(f"  population {S} x {N} x 8, summary: largest relative error "
        f"{rel:.3e} (rtol {SCAN_RTOL:g}) {'ok' if rel <= SCAN_RTOL else 'FAILED'}")
    if rel > SCAN_RTOL:
        raise AssertionError(f"c3_window population: {rel} off")
    ms = cuda_ms(lambda: c3_window_scan(*inp, 8, False), iters=10)
    plain_ms = cuda_ms(lambda: c3_window_ref(*inp, 8, False), iters=2,
                       warmup=1)
    table, L, B = inp[0], inp[1].numel(), inp[3].numel()
    Kc = inp[6].numel()
    nbytes = (8 * inp[5].numel() + 8 * 2 * L + 8 * 2 * B + 8 * inp[8].numel()
              + 4 * table.numel() + 8 * 2 * Kc + 8 * (B + L))
    flops = 6 * L * Kc        # per lane and kernel: 2 products, 2 divisions,
    #                           2 adds, what every lane needs once
    b_ms, b_by = bound(nbytes, flops, torch.float64)
    log(f"  population: kernel {ms:.4f} ms (one sample {one_ms:.4f} ms), "
        f"plain {plain_ms:.2f} ms, bound {b_ms * 1e3:.1f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {CARD}")
    del one, inp
    torch.cuda.empty_cache()
    read = dict(name="c3_window", route="cuda",
                source="src/repro_torch/kernels/csrc/c3_window.cu",
                replaces="none: XLA jit of _iteration_scan, "
                         "src/repro/core/jax_engine.py:198",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, sample_ms=one_ms,
                shape=f"{S} samples x {N} nodes x 8 lanes, Kc {Kc}, summary")
    return [read, *c3_window_draw_checks(g)]


def draw_inputs(g, wl, G: int, S: int, N: int, spike: bool = True,
                datum: int = 31) -> tuple:
    """The draw form's inputs at the fleet's settings: S samples of N nodes
    of G lanes, each lane at a clock drawn in [f_min, f_max], raw keys from
    the generator, SimConfig's sigma and comm base, spikes at p 0.2 (the
    tests' setting) and SimConfig's multiplier."""
    dev, f64 = str(g.device), torch.float64
    plan = torch_engine.window_plan(wl)
    A = workload_arrays(wl)
    p, sim = PRESETS[FLEET["preset"]], SimConfig(**FLEET["sim"])
    L, B = S * N * G, S * N
    f = p.f_min + (p.f_max - p.f_min) * torch.rand(L, generator=g, device=dev,
                                                   dtype=f64)
    rate_f = p.peak_gflops * sim.gemm_eff * (f / p.f_max)
    rm = torch.full((B,), p.hbm_gbps, dtype=f64, device=dev)
    keys = torch.randint(-2 ** 31, 2 ** 31, (S, 2), generator=g, device=dev,
                         dtype=torch.int32)
    base = (torch.as_tensor(A["cbytes"], device=dev)
            / (sim.comm_gbps * 1e9)).expand(S, -1).contiguous()

    def per_sample(v):
        return torch.full((S,), float(v), dtype=f64, device=dev)
    return (torch_engine._table(plan, dev), rate_f,
            rate_f / (1.0 + sim.kappa_comp), rm, rm / (1.0 + sim.kappa_mem),
            keys, datum, per_sample(sim.noise), base, per_sample(0.2),
            per_sample(sim.comm_spike_mult), spike,
            torch.as_tensor(A["gflop"], device=dev),
            torch.as_tensor(A["gbyte"], device=dev))


def bit_diff(got, want) -> int:
    """How many elements of a kernel's outputs are not bit-equal to the
    plain version's."""
    return sum(int((a != b).sum()) for a, b in zip(got, want))


def c3_window_draw_checks(g) -> list:
    """The draw form (run_fleet_scan's: the noise drawn in the kernel from
    JAX's streams) against its plain version, c3_window_draw_ref: one
    256-node fleet, groups of 3 and 12 (shared memory), spikes on, then the
    population; two planted controls (a sample key off by one, the
    iteration's datum off by one) must fail.  Then jax_normal against
    jax_normal_ref at 7b's tp shape.  Times at the population's shape
    (CUDA events, L2 flushed), beside the path it replaced at the same
    shape: the read form fed by per-sample torch.Generator draws (normal_, uniform_)
    and the elementwise passes that made the noise (mul_, exp_, where), in
    turns in this call."""
    log("c3_window draw form (kernel vs plain, float64):")
    wl = fleet_workload()
    S, N = FLEET["pop_samples"], FLEET["pop_nodes"]
    cases = [("256 nodes x 8", 8, 1, N, "shuffle"),
             ("groups of 3", 3, 2, 50, "shared"),
             ("groups of 12", 12, 2, 20, "shared"),
             (f"population {S} x {N} x 8", 8, S, N, "shuffle")]
    err = 0.0
    for name, G, s, n, want_path in cases:
        inp = draw_inputs(g, wl, G, s, n)
        got, path = took(c3_window_draw_scan,
                         lambda: c3_window_draw_scan(*inp, G))
        want = c3_window_draw_ref(*inp, G)
        rel, e = scan_err(got, want)
        err = max(err, e)
        ok = rel <= SCAN_RTOL and path == want_path
        log(f"  {name} [{path}]: largest relative error {rel:.3e} (rtol "
            f"{SCAN_RTOL:g}), {bit_diff(got, want)} of "
            f"{sum(x.numel() for x in got)} elements not bit-equal "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"c3_window draw {name}: {rel} off the "
                                 f"plain version, or took {path}")
        if s == 1:
            keys = inp[5].clone()
            keys[0, 1] += 1
            for what, bad in (("a sample key off by one",
                               inp[:5] + (keys,) + inp[6:]),
                              ("the iteration's datum off by one",
                               inp[:6] + (inp[6] + 1,) + inp[7:])):
                rel, _ = scan_err(c3_window_draw_scan(*bad, G), want)
                log(f"  control, {what}: {rel:.3e} "
                    f"{'fails, as it must' if rel > SCAN_RTOL else 'PASSES'}")
                if not rel > SCAN_RTOL:
                    raise AssertionError(f"c3_window draw: the control with "
                                         f"{what} passed")
    pop = inp
    table, L, B, Kc = pop[0], pop[1].numel(), pop[3].numel(), pop[12].numel()
    Km = pop[8].shape[1]
    P = L // S
    # the replaced path at this shape: a generator a sample, its draws,
    # the elementwise passes, then the read form
    gens = [torch.Generator(device="cuda").manual_seed(k) for k in range(S)]
    noise = torch.empty((S, Kc, P), dtype=torch.float64, device="cuda")
    dur = torch.empty((S, N, Km), dtype=torch.float64, device="cuda")
    spikes = torch.empty((2, S, N, Km), dtype=torch.float64, device="cuda")
    sig, base, sp, mult = (pop[7].view(S, 1, 1), pop[8][:, None, :],
                           pop[9].view(S, 1, 1), pop[10].view(S, 1, 1))

    def old_path():
        for k, gen in enumerate(gens):
            noise[k].normal_(generator=gen)
            dur[k].normal_(generator=gen)
            spikes[0, k].uniform_(generator=gen)
            spikes[1, k].uniform_(generator=gen)
        noise.mul_(sig).exp_()
        d = base * torch.exp(sig * dur)
        d = d * torch.where(spikes[0] < sp, mult * (1.0 + spikes[1]), 1.0)
        return c3_window_scan(table, *pop[1:5], noise, pop[12], pop[13],
                              d.reshape(S * N, Km), 8, False)
    times = {"draw": [], "old": []}
    for arm in ("draw", "old", "old", "draw"):
        fn = ((lambda: c3_window_draw_scan(*pop, 8)) if arm == "draw"
              else old_path)
        times[arm].append(cuda_ms(fn, iters=10))
    ms, old_ms = (sum(v) / 2 for v in (times["draw"], times["old"]))
    plain_ms = cuda_ms(lambda: c3_window_draw_ref(*pop, 8), iters=2, warmup=1)
    # what the function needs, whichever thread does it: an iteration's keys
    # once a sample (fold_in; split to k1, k2, k3; under spikes k3 to ks,
    # ku), a factor a lane and kernel, a group's Km durations (a normal, a
    # uniform under spikes, and a second where this run's spike fires)
    spike = pop[11]
    k = prng.split(prng.fold_in(pop[5], pop[6]), 3)
    fires = int((prng.uniform(prng.split(k[:, 2], 2)[:, 0], (N, Km))
                 < pop[9].view(S, 1, 1)).sum()) if spike else 0
    comm_draws = B * Km * (2 if spike else 1) + fires
    int_ops = (S * (6 if spike else 3) * KEY_INT_OPS
               + (L * Kc + comm_draws) * DRAW_INT_OPS)
    fp64 = (L * Kc * (FACTOR_FP64_FLOPS + SCAN_FP64_FLOPS)
            + B * Km * (FACTOR_FP64_FLOPS + 1)       # times the base
            + (comm_draws - B * Km) * UNIFORM_FP64_FLOPS
            + fires * 3)                             # mult (1 + u) times d
    nbytes = (8 * 2 * L + 8 * 2 * B + 8 * 2 * S + 8 * 4 * S + 8 * S * Km
              + 4 * table.numel() + 8 * 2 * Kc + 8 * (B + L))
    t_int = int_ops / INT32_OPS_PER_S * 1e3
    b_ms, b_by = bound(nbytes, fp64, torch.float64)
    if t_int > b_ms:
        b_ms, b_by = t_int, "operations"
    log(f"  population {S} x {N} x 8, summary: draw form "
        f"{', '.join(f'{t:.4f}' for t in times['draw'])} ms, the replaced "
        f"generator draws + elementwise + read form "
        f"{', '.join(f'{t:.4f}' for t in times['old'])} ms (in turns "
        f"draw, old, old, draw); plain {plain_ms:.2f} ms; bound "
        f"{b_ms * 1e3:.1f} us ({b_by}: INT32 {int_ops / 1e9:.4f} G ops "
        f"{t_int * 1e3:.1f} us, float64 {fp64 / 1e9:.4f} GFLOP "
        f"{fp64 / PEAK_FLOPS[torch.float64] * 1e6:.1f} us, "
        f"{nbytes / 1e6:.1f} MB {nbytes / HBM_BYTES_PER_S * 1e6:.1f} us; "
        f"{fires} of {B * Km} comms spiked); {CARD}")
    del noise, dur, spikes, pop, inp
    torch.cuda.empty_cache()
    draw = dict(name="c3_window_draw", route="cuda",
                source="src/repro_torch/kernels/csrc/c3_window.cu",
                replaces="none: XLA jit of _iteration_scan and of "
                         "draw_noise's jax.random draws, "
                         "src/repro/core/jax_engine.py:198,573",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, old_path_ms=old_ms,
                shape=f"{S} samples x {N} nodes x 8 lanes, Kc {Kc}, Km "
                      f"{Km}, spikes on, summary")
    # jax_normal at 7b's tp shape: 16 samples x 256 nodes x 16 syncs
    Sn, M = FLEET["topo_samples"], N * 16
    keys = torch.randint(-2 ** 31, 2 ** 31, (Sn, 2), generator=g,
                         device="cuda", dtype=torch.int32)
    got = jax_normal_draw(keys, 2 ** 20 + 5, M)
    want = jax_normal_ref(keys, 2 ** 20 + 5, M)
    rel, e = scan_err((got,), (want,))
    ok = rel <= SCAN_RTOL
    log(f"jax_normal (kernel vs plain, float64), {Sn} keys x {M}: largest "
        f"relative error {rel:.3e} (rtol {SCAN_RTOL:g}), "
        f"{bit_diff((got,), (want,))} of {got.numel()} not bit-equal "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"jax_normal: {rel} off the plain version")
    n_ms = cuda_ms(lambda: jax_normal_draw(keys, 2 ** 20 + 5, M))
    n_plain = cuda_ms(lambda: jax_normal_ref(keys, 2 ** 20 + 5, M), iters=5)
    n_bytes = 8 * Sn * M + 8 * Sn
    n_int = Sn * KEY_INT_OPS + Sn * M * DRAW_INT_OPS     # fold_in a key
    n_ms_b, n_by = bound(n_bytes, Sn * M * NORMAL_FP64_FLOPS, torch.float64)
    if n_int / INT32_OPS_PER_S * 1e3 > n_ms_b:
        n_ms_b, n_by = n_int / INT32_OPS_PER_S * 1e3, "operations"
    log(f"  jax_normal: kernel {n_ms:.4f} ms, plain {n_plain:.3f} ms, bound "
        f"{n_ms_b * 1e3:.2f} us ({n_by}); {CARD}")
    normal = dict(name="jax_normal", route="cuda",
                  source="src/repro_torch/kernels/csrc/c3_window.cu",
                  replaces="none: XLA jit of jax.random.normal, the TP "
                           "jitter, src/repro/core/jax_engine.py:586",
                  max_abs_err=e, ms=n_ms, plain_ms=n_plain, bound_ms=n_ms_b,
                  bound_by=n_by, library_ms=None,
                  shape=f"{Sn} keys x {M} normals")
    return [draw, normal]


def fleet(engine: str, n: int, seed: int = FLEET["seed"]) -> ClusterSim:
    """The cluster/dp scenario's fleet of ``n`` nodes on ``engine``, at its
    700 W caps after the warmup."""
    c = ClusterSim(fleet_workload(), PRESETS[FLEET["preset"]],
                   SimConfig(**FLEET["sim"]),
                   ClusterConfig(n_nodes=n, straggler_boost=FLEET["boost"],
                                 topology="dp", engine=engine),
                   devices_per_node=FLEET["devices"], seed=seed)
    for k in range(n):
        c.set_node_caps(k, np.full(c.G, FLEET["cap_w"]))
    return c


FLEET_KERNELS = (c3_window_scan, c3_window_draw_scan, jax_normal_draw)


def counted_run(runs: dict, name: str, expected: dict, call):
    """call() with the fleet kernels' counts set to 0 just before and read
    just after, as run ``name``; each wrapper's launches must equal
    ``expected[its name]`` (0 where it is not named)."""
    for fn in FLEET_KERNELS:
        _build.reset_counts(fn)
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    runs[name] = ({fn.__name__: fn.launches for fn in FLEET_KERNELS},
                  {fn.__name__: dict(fn.launches_by_path)
                   for fn in FLEET_KERNELS})
    got = {k: v for k, v in runs[name][0].items() if v}
    if got != {k: v for k, v in expected.items() if v}:
        raise AssertionError(f"{name}: launches {got}, expected {expected}")
    return out, secs


def close_traces(a, b, what: str) -> float:
    """Every trace matrix of ``a`` within rtol 1e-9, atol 1e-12 of ``b``,
    NaN patterns equal; returns the largest relative difference."""
    worst = 0.0
    for ta, tb in zip(a, b):
        for field in ("comp_start", "comp_end", "comp_overlap", "comm_start",
                      "comm_end", "util"):
            x, y = getattr(ta, field), getattr(tb, field)
            if not np.array_equal(np.isnan(x), np.isnan(y)) or not np.allclose(
                    x, y, rtol=ENGINE_RTOL, atol=ENGINE_ATOL, equal_nan=True):
                raise AssertionError(f"{what}: {field} off the vector engine")
            d = np.abs(np.nan_to_num(x) - np.nan_to_num(y))
            if d.size:
                worst = max(worst, float((d / np.maximum(
                    np.abs(np.nan_to_num(y)), 1e-300)).max()))
    return worst


def scan_population(spec_kw: dict, samples: int, nodes: int, iters: int,
                    collect: str, topology: str = "dp"):
    """A fleet scan's spec and the stacked arrays of ``samples`` fleets of
    ``nodes`` nodes (thermal seeds seed + k, noise keys k), as the JAX
    package's sweep stacks them; ``samples`` 0: one fleet, unstacked."""
    wl, sim = fleet_workload(), SimConfig(**FLEET["sim"])
    cc = ClusterConfig(n_nodes=nodes, straggler_boost=FLEET["boost"],
                       topology=topology)
    spec = torch_engine.fleet_scan_spec(wl, sim, cc, iters, collect=collect,
                                        devices_per_node=FLEET["devices"])
    if spec_kw:
        spec = dataclasses.replace(spec, **spec_kw)
    arrays = [torch_engine.build_fleet_arrays(
        wl, PRESETS[FLEET["preset"]], sim, cc, FLEET["cap_w"],
        FLEET["seed"] + k, devices_per_node=FLEET["devices"], rng_seed=k)
        for k in range(max(samples, 1))]
    if not samples:
        return spec, arrays[0]
    return spec, {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}


# the six (topology, collect, samples) cases the CPU tests hold the port's
# scan to the JAX package's in (tests/test_torch_engine.py SCAN_CASES)
SCAN_CASES = (("dp", "full", 2), ("dp", "summary", 0), ("pp", "full", 0),
              ("pp", "summary", 2), ("tp", "full", 2), ("tp", "summary", 2))


def scan_on_card_against_cpu() -> None:
    """run_fleet_scan on the card against the same call with device "cpu"
    (prng.py and the plain scan: the path the CPU tests hold to the JAX
    package's scan at rtol 1e-9) in SCAN_CASES, at the tests' settings: a
    2-layer llama3.1-8b iteration, 4 nodes of mixed presets with churn on
    node 0, noise 0.008, spikes at p 0.2, the default TP jitter, 24
    iterations; every series within ENGINE_RTOL / ENGINE_ATOL, the slowest
    and straggler nodes equal."""
    wl = fsdp_llm_iteration(get_config(FLEET["arch"]).replace(n_layers=2),
                            batch=2, seq=4096, n_shards=8)
    sim = SimConfig(seed=1, comm_gbps=40.0, noise=0.008, comm_spike_p=0.2)
    for topo, collect, samples in SCAN_CASES:
        cc = ClusterConfig(
            n_nodes=4, straggler_boost=FLEET["boost"], topology=topo,
            node_presets=["mi300x", "mi300x-air", "mi300x", "v5e"],
            churn={0: ChurnModel(drift_rate=0.3,
                                 events=[ChurnEvent(0.0, 3, 1.4)])})
        spec = torch_engine.fleet_scan_spec(wl, sim, cc, 24, collect=collect)
        arrays = [torch_engine.build_fleet_arrays(
            wl, PRESETS["mi300x"], sim, cc, FLEET["cap_w"], 5 + k, rng_seed=k)
            for k in range(max(samples, 1))]
        arrays = ({k: np.stack([a[k] for a in arrays]) for k in arrays[0]}
                  if samples else arrays[0])
        got = torch_engine.run_fleet_scan(spec, arrays)
        want = torch_engine.run_fleet_scan(spec, arrays, device="cpu")
        worst, close, nodes = 0.0, True, True
        for key in want:
            a, b = got[key], want[key]
            if key in ("slowest_node", "straggler_node"):
                nodes &= bool(np.array_equal(a, b))
                continue
            close &= bool(np.allclose(a, b, rtol=ENGINE_RTOL,
                                      atol=ENGINE_ATOL))
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
                np.abs(b), 1e-300))))
        log(f"7b: the scan on the card against the CPU's (the path held to "
            f"JAX's), {topo} {collect}, {max(samples, 1)} x 4 nodes, noise "
            f"0.008, spikes p 0.2: largest relative difference {worst:.3e} "
            f"(rtol {ENGINE_RTOL:g}, atol {ENGINE_ATOL:g}) "
            f"{'ok' if close else 'FAILED'}, "
            f"{sum(int((got[k] != want[k]).sum()) for k in want)} values not "
            f"bit-equal; slowest and straggler nodes "
            f"{'equal' if nodes else 'DIFFER'}")
        if not (close and nodes):
            raise AssertionError(f"7b {topo} {collect}: the scan on the card "
                                 f"is off the CPU's")


def tail_means(t_fleet, power, n: int = 30) -> dict:
    t, p = np.asarray(t_fleet)[-n:], np.asarray(power)[-n:]
    return {"t_fleet": float(t.mean()), "throughput": float((1 / t).mean()),
            "power": float(p.mean())}


def fleet_sim(args) -> tuple:
    """Phase 7, the fleet simulator at the cluster scenarios' settings.
    Returns {run: (launch counts, counts by path)} of the window scan, and
    the seconds of 7b's population's first and second (warm) call."""
    runs: dict = {}
    n4, iters = FLEET["nodes"], FLEET["iterations"]
    # 7a: the engine against the vector engine, then the managed fleet
    ct, cv = fleet("torch", n4), fleet("vector", n4)
    steps = FLEET["engine_steps"]
    tt, t_secs = counted_run(runs, f"7a dp {n4} nodes",
                             {"c3_window_scan": steps},
                             lambda: [ct.step() for _ in range(steps)])
    t0 = time.perf_counter()
    tv = [cv.step() for _ in range(steps)]
    v_secs = time.perf_counter() - t0
    worst = max(close_traces(a, b, "7a") for a, b in zip(tt, tv))
    ht, hv = ([h["t_fleet"] for h in c.history] for c in (ct, cv))
    if not np.allclose(ht, hv, rtol=ENGINE_RTOL, atol=0.0):
        raise AssertionError("7a: t_fleet history off the vector engine")
    log(f"7a: {n4}-node dp fleet, {steps} iterations, engine torch on the "
        f"card against vector on the host: every trace matrix within rtol "
        f"{ENGINE_RTOL:g} (largest {worst:.3e}), NaN patterns and t_fleet "
        f"history equal; ms per iteration torch {t_secs / steps * 1e3:.3f}, "
        f"vector {v_secs / steps * 1e3:.3f}; {CARD}")
    knobs = dict(FLEET["manager"],
                 cluster_power_budget=n4 * FLEET["devices"] * FLEET["cap_w"])
    managed = {}
    for engine in ("torch", "vector"):
        c = fleet(engine, n4)

        def loop():
            return run_fleet_closed_loop(ClusterSimBackend(c),
                                         FleetManagerConfig(**knobs), iters,
                                         tune_after=FLEET["tune_after"])
        if engine == "torch":
            mgr, secs = counted_run(runs, f"7a managed {n4} nodes",
                                    {"c3_window_scan": iters}, loop)
        else:
            t0 = time.perf_counter()
            mgr = loop()
            secs = time.perf_counter() - t0
        caps = np.stack([c.get_node_caps(k) for k in range(n4)])
        managed[engine] = (caps, np.array([h["t_fleet"] for h in c.history]),
                           np.stack(mgr.budget_log), secs)
    (ca, ha, ba, ta), (cb, hb, bb, tb) = managed["torch"], managed["vector"]
    same = (ba.shape == bb.shape and np.allclose(ca, cb, rtol=ENGINE_RTOL)
            and np.allclose(ha, hb, rtol=ENGINE_RTOL)
            and np.allclose(ba, bb, rtol=ENGINE_RTOL))
    log(f"7a: managed fleet (gpu-realloc, {iters} iterations, tuning from "
        f"{FLEET['tune_after']}): {len(ba)} budget moves, caps and t_fleet "
        f"history {'equal within 1e-9' if same else 'DIFFER'}; t_fleet "
        f"tail {ha[-1]:.6f} s; ms per iteration torch "
        f"{ta / iters * 1e3:.3f}, vector {tb / iters * 1e3:.3f}")
    if not same:
        raise AssertionError("7a: the managed fleet's caps or history differ")
    # 7b: a Monte-Carlo population of 256-node fleets
    S, N = FLEET["pop_samples"], FLEET["pop_nodes"]
    t0 = time.perf_counter()
    spec, arrays = scan_population({}, S, N, iters, "summary")
    build_s = time.perf_counter() - t0
    T = spec.warmup + iters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    draws = {"c3_window_draw_scan": T}
    out, pop_secs = counted_run(
        runs, f"7b dp {S} x {N} nodes", draws,
        lambda: torch_engine.run_fleet_scan(spec, arrays))
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite = all(np.isfinite(v).all() for v in out.values())
    shapes = (out["t_fleet"].shape == (S, iters)
              and out["temp"].shape == (S, N, FLEET["devices"]))
    tm = tail_means(out["t_fleet"].mean(0), out["fleet_power"].mean(0))
    out2, warm_secs = counted_run(
        runs, f"7b dp {S} x {N} nodes, again", draws,
        lambda: torch_engine.run_fleet_scan(spec, arrays))
    same = all(np.array_equal(out[k], out2[k]) for k in out)
    log(f"7b: {S} samples x {N} nodes x {FLEET['devices']} lanes "
        f"({S * N * FLEET['devices']:,} lanes), {spec.warmup} + {iters} "
        f"iterations, summary: first call {pop_secs:.3f} s, second (warm) "
        f"{warm_secs:.3f} s on the card ({warm_secs / T * 1e3:.2f} ms an "
        f"iteration of the population, {warm_secs / T / S * 1e3:.3f} a "
        f"fleet), {T} launches a call, peak {peak:.2f} GB; arrays built in "
        f"{build_s:.2f} s on the host; t_fleet tail mean {tm['t_fleet']:.6f} s, "
        f"fleet power {tm['power'] / 1e3:.1f} kW; finite {finite}, shapes "
        f"{'ok' if shapes else 'WRONG'}, the two calls equal {same}; {CARD}")
    if not (finite and shapes and same):
        raise AssertionError("7b: the population's output is not finite, not "
                             "of the expected shape, or not reproduced")
    host_profile(S, N)
    wl = fleet_workload()
    sims = [C3Sim(wl, PRESETS[FLEET["preset"]],
                  SimConfig(**dict(FLEET["sim"], seed=FLEET["sim"]["seed"]
                                   + n)), FLEET["devices"])
            for n in range(N)]
    freqs = [np.full(FLEET["devices"], PRESETS[FLEET["preset"]].f_max)] * N
    noises = [[s._draw_noise() for s in sims] for _ in range(3)]
    t0 = time.perf_counter()
    for nz in noises:
        tv = vector_iteration(sims, freqs, nz)
    v_ms = (time.perf_counter() - t0) / 3 * 1e3
    tt, secs = counted_run(runs, f"7b torch_iteration {N} nodes",
                           {"c3_window_scan": 3}, lambda: [
        torch_engine.torch_iteration(sims, freqs, nz) for nz in noises])
    worst = close_traces(tt[-1], tv, "7b torch_iteration")
    log(f"7b: one {N}-node iteration from the numpy noise: vector engine "
        f"{v_ms:.2f} ms on the host, torch_iteration {secs / 3 * 1e3:.2f} ms "
        f"(the trace to and from the card included; rtol {worst:.2e}); the "
        f"scan {warm_secs / T / S * 1e3:.3f} ms a fleet-iteration in the "
        f"population")
    for topo in ("dp", "pp", "tp"):
        small = scan_population(dict(warmup=2, spike=True), 2, N, 3, "full",
                                topo)
        small[1]["comm_spike_p"] = np.full(2, 0.2)
        got = torch_engine.run_fleet_scan(*small)
        with mock.patch.object(c3_ops, "c3_window_draw", c3_window_draw_ref), \
                mock.patch.object(c3_ops, "jax_normal", jax_normal_ref):
            want = torch_engine.run_fleet_scan(*small)
        worst = max(float(np.max(np.abs(got[k] - want[k]) / np.maximum(
            np.abs(want[k]), 1e-300))) for k in got)
        log(f"7b: the scan's kernel path against its plain path, {topo}, "
            f"the same keys (2 x {N} nodes, 2 + 3 iterations, spikes on, "
            f"full): largest relative difference {worst:.3e}, "
            f"{sum(int((got[k] != want[k]).sum()) for k in got)} values not "
            f"bit-equal (rtol {SCAN_RTOL:g})")
        if not worst <= SCAN_RTOL:
            raise AssertionError(f"7b {topo}: the scan's kernel path is off "
                                 f"its plain path")
    scan_on_card_against_cpu()
    spec1, arrays1 = scan_population({}, 0, N, iters, "full")
    out, secs = counted_run(runs, f"7b dp {N} nodes full", draws,
                            lambda: torch_engine.run_fleet_scan(spec1, arrays1))
    ok = (out["t_local"].shape == (iters, N) and out["lead"].shape == (iters, N)
          and all(np.isfinite(v).all() for v in out.values())
          and np.allclose(out["lead"].min(1), 0.0))
    log(f"7b: one {N}-node fleet, collect full: {secs:.3f} s, t_local "
        f"{out['t_local'].shape}, straggler lead 0 every iteration "
        f"{'ok' if ok else 'WRONG'}")
    if not ok:
        raise AssertionError("7b: the full collection is wrong")
    for topo in ("pp", "tp"):
        spec_t, arrays_t = scan_population({}, FLEET["topo_samples"], N, iters,
                                           "summary", topo)
        out, secs = counted_run(
            runs, f"7b {topo} {FLEET['topo_samples']} x {N} nodes",
            {"c3_window_draw_scan": T,
             "jax_normal_draw": iters if topo == "tp" else 0},
            lambda: torch_engine.run_fleet_scan(spec_t, arrays_t))
        ok = all(np.isfinite(v).all() for v in out.values())
        log(f"7b: {topo}, {FLEET['topo_samples']} samples x {N} nodes: "
            f"{secs:.3f} s; t_fleet tail mean "
            f"{tail_means(out['t_fleet'].mean(0), out['fleet_power'].mean(0))['t_fleet']:.6f} s; "
            f"finite {ok}")
        if not ok:
            raise AssertionError(f"7b {topo}: not finite")
    # 7c: the statistics, the scan against stepping ClusterSim per sample
    k3, it3 = FLEET["stat_samples"], FLEET["stat_iterations"]
    spec3, arrays3 = scan_population({}, k3, n4, it3, "summary")
    out, _ = counted_run(runs, f"7c dp {k3} x {n4} nodes",
                         {"c3_window_draw_scan": spec3.warmup + it3},
                         lambda: torch_engine.run_fleet_scan(spec3, arrays3))
    worst = 0.0
    for k in range(k3):
        c = fleet("vector", n4, FLEET["seed"] + k)
        for _ in range(it3):
            c.step()
        want = tail_means([h["t_fleet"] for h in c.history],
                          [h["power"] for h in c.history])
        got = tail_means(out["t_fleet"][k], out["fleet_power"][k])
        worst = max(worst, *(abs(got[m] / want[m] - 1) for m in got))
    log(f"7c: {k3} samples of the {n4}-node dp fleet, {it3} iterations: "
        f"tail means of t_fleet, throughput and fleet power, the scan on the "
        f"card against ClusterSim stepped on the host, largest relative "
        f"difference {worst:.3e} (limit {STAT_REL:g})")
    if not worst <= STAT_REL:
        raise AssertionError("7c: the scan's statistics are off ClusterSim's")
    return runs, (pop_secs, warm_secs)


def host_profile(S: int, N: int, iters: int = 8) -> None:
    """Where the host's time goes in an iteration of the population's scan:
    cProfile (host only, no CUDA tracing) over a scan of 2 + ``iters``
    iterations, self time per iteration by function."""
    import cProfile
    import pstats
    spec, arrays = scan_population(dict(warmup=2), S, N, iters, "summary")
    torch_engine.run_fleet_scan(spec, arrays)
    prof = cProfile.Profile()
    prof.enable()
    torch_engine.run_fleet_scan(spec, arrays)
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    n = spec.warmup + iters
    total = sum(v[2] for v in st.stats.values())
    rows = sorted(((v[2], v[1], f"{Path(k[0]).name}:{k[1]}({k[2]})")
                   for k, v in st.stats.items()), reverse=True)
    log(f"7b: host profile of the scan ({S} x {N} nodes, cProfile), "
        f"{total / n * 1e3:.3f} ms of self time an iteration; the largest:")
    for secs, calls, where in rows[:8]:
        log(f"  {secs / n * 1e3:8.3f} ms  x{calls / n:<6.1f} {where[:90]}")


def launches_per_iteration(S: int, N: int) -> float:
    """CUDA launches an iteration of the population's scan (torch.profiler,
    kernels and copies): the difference between scans of 2 + 6 and 2 + 2
    iterations, over 4."""
    counts = []
    for iters in (2, 6):
        spec, arrays = scan_population(dict(warmup=2), S, N, iters, "summary")
        torch_engine.run_fleet_scan(spec, arrays)
        ev = profiled_kernels(lambda: (
            torch_engine.run_fleet_scan(spec, arrays),
            torch.cuda.synchronize()))
        counts.append(sum(e.count for e in ev))
    return (counts[1] - counts[0]) / 4


# --------------------------------------------------------------------------- #
# Phase 3: serve llama3.1-8b, deepseek-v3-16b and rwkv6-3b
# --------------------------------------------------------------------------- #
def rmsnorms(cfg) -> tuple:
    """(RMSNorm kernel launches a layer, and after the layers) in one
    forward: ln1, ln2 (and q, k with qk-norm), the final norm; a LayerNorm
    model (nemotron-4-15b) norms in plain torch and launches none."""
    if cfg.norm == "layernorm":
        return 0, 0
    return (4 if cfg.qk_norm else 2), 1


def expected_launches(cfg, new_tokens: int) -> dict:
    """Launches of each kernel in one served run: prefill + new_tokens - 1
    decode steps, new_tokens forwards in all."""
    n_moe = (cfg.n_layers - cfg.moe.first_k_dense) if cfg.moe else 0
    no_backward = {"flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                   "moe_gemm_dgrad": 0, "moe_gemm_wgrad": 0}
    if cfg.family == "rwkv":      # no attention; ln0 after the embedding
        return {"flash_attention_fwd": 0,
                "rmsnorm_fwd": (2 * cfg.n_layers + 2) * new_tokens,
                "moe_gemm_fwd": 0,
                "wkv6_fwd": cfg.n_layers * new_tokens, **no_backward}
    per_layer, final = rmsnorms(cfg)
    return {"flash_attention_fwd": cfg.n_layers,         # prefill only
            "rmsnorm_fwd": (per_layer * cfg.n_layers + final) * new_tokens,
            "moe_gemm_fwd": 3 * n_moe * new_tokens,
            "wkv6_fwd": 0, **no_backward}


def serve(args, arch: str, prompt_len: int = 0) -> dict:
    """Serve ``arch`` at full width and depth (phase 3; prompts of
    ``prompt_len`` tokens, args.prompt_len by default): the launches of the
    run counted and checked, then timed and profiled."""
    cfg = get_config(arch)
    S = prompt_len or args.prompt_len
    model = build_model(cfg, max_cache_len=S + args.new_tokens)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, "cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    moe = (f"; MoE: {cfg.moe.n_experts} experts of {cfg.moe.d_expert}, "
           f"top-{cfg.moe.top_k} {cfg.moe.router}, {cfg.moe.n_shared} shared, "
           f"{cfg.moe.first_k_dense} dense layer(s) of {cfg.moe.d_ff_dense}"
           if cfg.moe else "")
    rwkv = (f"; RWKV6: WKV heads of {cfg.rwkv.head_dim}, decay lora "
            f"{cfg.rwkv.decay_lora}, mix lora {cfg.rwkv.mix_lora}, no "
            f"attention" if cfg.rwkv else "")
    ring = (f"; a sliding window of {cfg.window}, the KV cache a ring of "
            f"{model.cache_window} slots for {S + args.new_tokens} "
            f"positions" if getattr(model, "ring", False) else "")
    log(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.norm}, {cfg.activation}"
        f"{', QKV bias' if cfg.qkv_bias else ''}{moe}{rwkv}{ring}; weights "
        f"{n_bytes / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.1f} s (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB while made)")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, S)).astype(np.int32)
    loop = ServingLoop(model, params, args.batch, S,
                       ServeConfig(max_new_tokens=args.new_tokens),
                       device="cuda")

    log(f"launch counts before the run: "
        f"{ {k.__name__: k.launches for k in KERNELS} }; set to 0")
    for k in KERNELS:
        _build.reset_counts(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = loop.serve(prompts)                       # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    by_path = {k.__name__: dict(k.launches_by_path) for k in KERNELS
               if hasattr(k, "launches_by_path")}
    log(f"served {out.shape} tokens in {wall:.3f} s; launch counts after "
        f"the run: {launches}, by path: {by_path}")

    if out.shape != (args.batch, args.new_tokens) or out.min() < 0 \
            or out.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    for name, want in expected_launches(cfg, args.new_tokens).items():
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {want}")
    for name, paths in by_path.items():    # the Hopper kernels, every time
        if paths[SERVED_PATH[name]] != launches[name]:
            raise AssertionError(f"{name}: {paths} of {launches[name]} "
                                 f"launches; all must take the "
                                 f"{SERVED_PATH[name]} path")

    # timed breakdown on the same model (launches no longer counted)
    tokens = torch.from_numpy(prompts).long().cuda()
    with torch.inference_mode():
        for _ in range(2):                          # warm-up
            logits, cache = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if not torch.isfinite(logits[..., :cfg.vocab_size]).all():
            raise AssertionError("non-finite prefill logits")
        tok = logits[:, -1].argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for _ in range(args.new_tokens - 1):
            logits, cache = model.decode_step(params, tok, cache)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (args.new_tokens - 1)
        if not torch.isfinite(logits[..., :cfg.vocab_size]).all():
            raise AssertionError("non-finite decode logits")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{arch}: prefill {prefill_ms:.2f} ms (B {args.batch} x S "
        f"{S}); decode {decode_ms:.2f} ms/token step = "
        f"{args.batch * 1e3 / decode_ms:.1f} tokens/s; served "
        f"{args.batch * args.new_tokens / wall:.1f} tokens/s end to end; "
        f"peak memory {peak:.2f} GB; {CARD}")
    with torch.inference_mode():
        device_profile(f"{arch} prefill", prefill_ms,
                       lambda: model.prefill(params, {"tokens": tokens}))
        device_profile(f"{arch} decode step", decode_ms,
                       lambda: model.decode_step(params, tok, cache))
    del params, cache, loop
    torch.cuda.empty_cache()
    return launches, by_path


def _union(spans) -> list:
    """Sorted disjoint (start, end) intervals covering ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ms(prof) -> float:
    """The device's busy time in a profile: the union of its kernels' and
    copies' spans (kernels on two streams, as NCCL's beside the step's,
    count once where they overlap; the annotation ranges on the device
    timeline, as c10d's ``nccl:*``, not at all)."""
    from torch.autograd import DeviceType
    return sum(b - a for a, b in _union(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not e.is_user_annotation)) / 1e3


def collective_overlap(prof) -> tuple:
    """(collective ms, overlapped ms, exposed ms, {stream: busy ms, "c" for
    a collective stream}) of a profile, from the spans ``busy_ms`` joins.
    A collective span is an NCCL kernel, on whatever stream it runs (c10d
    runs a blocking collective on the caller's stream, an async one on its
    own), every kernel or copy on a stream that runs nothing but NCCL's
    kernels and copies (at a world of 1 NCCL copies), and a copy inside one
    of c10d's ``nccl:*`` annotation ranges on its stream; every other span
    is compute.  Collective ms: the union of the collective spans;
    overlapped: the part of it during which compute ran; exposed: the
    rest, during which the device only communicated."""
    from torch.autograd import DeviceType
    spans, marks, compute = [], {}, set()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        st, a, b = e.device_resource_id, e.time_range.start, e.time_range.end
        if e.is_user_annotation:
            if e.name.startswith("nccl:"):
                marks.setdefault(st, []).append((a, b))
            continue
        nccl = "nccl" in e.name.lower()
        copy = e.name.startswith(("Memcpy", "Memset"))
        spans.append((st, a, b, nccl, copy))
        if not nccl and not copy:
            compute.add(st)

    def collective(st, a, b, nccl, copy):
        return nccl or st not in compute or (copy and any(
            x <= a and b <= y for x, y in marks.get(st, ())))
    coll = _union((a, b) for sp in spans if collective(*sp)
                  for a, b in [sp[1:3]])
    work = _union((a, b) for sp in spans if not collective(*sp)
                  for a, b in [sp[1:3]])
    over, j = 0.0, 0
    for a, b in coll:                    # both lists sorted and disjoint
        while j < len(work) and work[j][1] <= a:
            j += 1
        k = j
        while k < len(work) and work[k][0] < b:
            over += min(b, work[k][1]) - max(a, work[k][0])
            k += 1
    total = sum(b - a for a, b in coll)
    streams = {f"{st}{'' if st in compute else 'c'}": round(sum(
        b - a for a, b in _union(sp[1:3] for sp in spans if sp[0] == st))
        / 1e3, 2) for st in sorted({sp[0] for sp in spans})}
    return total / 1e3, over / 1e3, (total - over) / 1e3, streams


def device_profile(what: str, step_ms: float, fn, top: int = 6):
    """Device time by kernel over one call of fn (torch.profiler), and the
    device's busy share of the unprofiled step time; returns the profile
    and the busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]
    busy = busy_ms(prof)
    log(f"{what} profile: device busy {busy:.2f} ms of {step_ms:.2f} ms "
        f"({100 * busy / step_ms:.1f}%, idle {100 - 100 * busy / step_ms:.1f}%)"
        f" in {sum(r[1] for r in rows)} kernel launches (their times summed "
        f"{sum(r[0] for r in rows):.2f} ms); {CARD}")
    ours = ("fa_fwd", "fa_bwd", "moe_gemm", "rms_", "wkv6_", "c3_window")
    for n, (ms, count, key) in enumerate(sorted(rows, reverse=True)):
        if n < top or any(k in key for k in ours):   # and the port's kernels
            log(f"  {ms:8.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  "
                f"x{count:<4d} {key[:90]}")
    return prof, busy


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------- #
# Phase 4: kernel path vs plain path at full width
# --------------------------------------------------------------------------- #
@contextmanager
def plain_path():
    """Route the ops of a CUDA run through the plain versions (autograd
    then differentiates them, as on the CPU)."""
    with mock.patch.object(fa_ops, "flash_attention", flash_attention_ref), \
            mock.patch.object(rms_ops, "rmsnorm", rmsnorm_ref), \
            mock.patch.object(moe_ops, "moe_gemm", moe_gemm_ref), \
            mock.patch.object(wkv_ops, "wkv6", wkv6_ref):
        yield


@contextmanager
def recorded_routes():
    """Collect the expert indices (T, k) of every routing call."""
    routes = []
    route = moe_mod._route

    def recording(cfg, logits):
        gates, idx, aux = route(cfg, logits)
        routes.append(idx.sort(-1).values)
        return gates, idx, aux

    with mock.patch.object(moe_mod, "_route", recording):
        yield routes


def kernel_vs_plain(args, arch: str = "llama3.1-8b", prompt_len: int = 0,
                    steps: int = 0) -> None:
    """A 2-layer full-width prefill of ``arch`` (prompts of ``prompt_len``,
    args.prompt_len by default), kernel path against plain path: the
    logits and the KV cache; then ``steps`` greedy decode steps (phase 3m:
    mistral-7b past its window, through the ring), both paths fed the
    kernel path's tokens so that their caches hold the same positions: each
    step's logits, and each greedy token the same on both paths unless the
    plain path's own margin to the kernel path's token is within the
    logits' tolerance (a near tie that the paths' roundings may order
    either way)."""
    cfg = get_config(arch).replace(n_layers=2)
    S = prompt_len or args.prompt_len
    model = build_model(cfg, max_cache_len=S + steps)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, S))).long().cuda()
    V = cfg.vocab_size
    with torch.inference_mode():
        lk, ck = model.prefill(params, {"tokens": tokens})
        with plain_path():
            lp, cp = model.prefill(params, {"tokens": tokens})
        diff = (lk[..., :V].float() - lp[..., :V].float()).abs()
        cache_diff = max(max_err(a, b) for a, b in zip(ck["k"] + ck["v"],
                                                       cp["k"] + cp["v"]))
        worst, same, ties = [float(diff.max()), float(diff.mean())], 0, 0
        for _ in range(steps):
            tok = lk[:, -1, :V].argmax(-1, keepdim=True)
            plain_tok = lp[:, -1, :V].argmax(-1, keepdim=True)
            margin = (lp[:, -1, :V].gather(-1, plain_tok)
                      - lp[:, -1, :V].gather(-1, tok)).flatten()
            agree = (tok == plain_tok).flatten()
            same += int(agree.sum())
            ties += int((~agree & (margin <= E2E_TOL["max_abs"])).sum())
            if not bool((agree | (margin <= E2E_TOL["max_abs"])).all()):
                raise AssertionError(f"{arch}: greedy tokens differ beyond a "
                                     f"near tie (plain margins {margin})")
            lk, ck = model.decode_step(params, tok, ck)
            with plain_path():
                lp, cp = model.decode_step(params, tok, cp)
            d = (lk[..., :V].float() - lp[..., :V].float()).abs()
            worst = [max(worst[0], float(d.max())),
                     max(worst[1], float(d.mean()))]
    ring = (f"; the cache a ring of {model.cache_window} slots"
            if getattr(model, "ring", False) else "")
    log(f"2-layer full-width {arch} prefill (B {args.batch} x S {S}"
        f"{f', then {steps} decode steps' if steps else ''}{ring}), kernel vs "
        f"plain path: logits max_abs {worst[0]:.3e} mean_abs {worst[1]:.3e} "
        f"(tol {E2E_TOL}), logit std {float(lp[..., :V].float().std()):.3f}; "
        f"prefill KV cache max_abs {cache_diff:.3e}"
        + (f"; greedy tokens the same in {same} of {steps * args.batch} "
           f"({ties} near ties)" if steps else ""))
    if worst[0] > E2E_TOL["max_abs"] or worst[1] > E2E_TOL["mean_abs"]:
        raise AssertionError(f"{arch}: kernel path and plain path disagree")
    del params, ck, cp
    torch.cuda.empty_cache()


def moe_kernel_vs_plain(args) -> None:
    """deepseek-v3-16b at full width: (a) the MoE block alone on one bf16
    input, (b) a 2-layer (dense + MoE) prefill."""
    cfg = get_config("deepseek-v3-16b").replace(n_layers=2)
    model = build_model(cfg, max_cache_len=args.prompt_len)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, "cuda")

    # (a) the block alone: the router sees identical bits on both paths
    x = torch.randn(args.batch, args.prompt_len, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    p = params["layers"][1]["ffn"]
    with torch.inference_mode(), recorded_routes() as routes:
        ok, _ = moe_mod.moe_forward(cfg, p, x)
        with plain_path():
            op, _ = moe_mod.moe_forward(cfg, p, x)
    diff = (ok.float() - op.float()).abs()
    same_route = torch.equal(routes[0], routes[1])
    log(f"MoE block alone (B {args.batch}, S {args.prompt_len}, bf16), kernel "
        f"vs plain path: max_abs {float(diff.max()):.3e} mean_abs "
        f"{float(diff.mean()):.3e} (tol {MOE_BLOCK_TOL}), output std "
        f"{float(op.float().std()):.3f}; identical routing: {same_route}")
    if not same_route or float(diff.max()) > MOE_BLOCK_TOL["max_abs"] or \
            float(diff.mean()) > MOE_BLOCK_TOL["mean_abs"]:
        raise AssertionError("MoE block: kernel path and plain path disagree")

    # (b) 2-layer prefill: compare the rows whose last token kept its experts
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).long().cuda()
    with torch.inference_mode(), recorded_routes() as routes:
        lk, _ = model.prefill(params, {"tokens": tokens})
        with plain_path():
            lp, _ = model.prefill(params, {"tokens": tokens})
    flipped = (routes[0] != routes[1]).any(-1).view(args.batch,
                                                    args.prompt_len)
    share = float(flipped.float().mean())
    rows = ~flipped[:, -1]
    if int(rows.sum()) < max(args.batch // 2, 1):
        raise AssertionError(f"2-layer MoE prefill: the last token of "
                             f"{int((~rows).sum())} of {args.batch} rows took "
                             f"another expert set")
    V = cfg.vocab_size
    diff = (lk[rows, :, :V].float() - lp[rows, :, :V].float()).abs()
    log(f"2-layer full-width deepseek-v3-16b prefill, kernel vs plain path: "
        f"{int(flipped.sum())} of {flipped.numel()} tokens ({100 * share:.2f}%,"
        f" limit {100 * MAX_FLIPPED_SHARE:.0f}%) took another layer-1 expert "
        f"set; {int(rows.sum())} of {args.batch} rows kept the last token's "
        f"experts, their logits max_abs {float(diff.max()):.3e} mean_abs "
        f"{float(diff.mean()):.3e} (tol {E2E_TOL}), logit std "
        f"{float(lp[..., :V].float().std()):.3f}")
    if share > MAX_FLIPPED_SHARE or float(diff.max()) > E2E_TOL["max_abs"] or \
            float(diff.mean()) > E2E_TOL["mean_abs"]:
        raise AssertionError("2-layer MoE prefill: kernel path and plain "
                             "path disagree")


def rwkv_kernel_vs_plain(args, steps: int = 4) -> None:
    """rwkv6-3b at full width, 2 layers: prefill, then decode steps on the
    same fed tokens, each path from its own cache.  Both paths run the fp32
    recurrence on bf16 r, k, v and round y to bf16 at the same point; the
    sums run in another order, so values on a rounding boundary move one
    bf16 step and such flips compound through 2 layers: E2E_TOL, as for
    llama's prefill."""
    cfg = get_config("rwkv6-3b").replace(n_layers=2)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, "cuda")
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).long().cuda()
    feed = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, steps))).long().cuda()
    V = cfg.vocab_size
    worst = {"max_abs": 0.0, "mean_abs": 0.0}
    with torch.inference_mode():
        lk, ck = model.prefill(params, {"tokens": tokens})
        with plain_path():
            lp, cp = model.prefill(params, {"tokens": tokens})
        for t in range(steps + 1):
            if t:
                lk, ck = model.decode_step(params, feed[:, t - 1:t], ck)
                with plain_path():
                    lp, cp = model.decode_step(params, feed[:, t - 1:t], cp)
            if not torch.isfinite(lk[..., :V]).all():
                raise AssertionError("non-finite rwkv6-3b logits")
            diff = (lk[..., :V].float() - lp[..., :V].float()).abs()
            worst["max_abs"] = max(worst["max_abs"], float(diff.max()))
            worst["mean_abs"] = max(worst["mean_abs"], float(diff.mean()))
    state_diff = [max_err(a, b) for a, b in zip(ck["wkv"], cp["wkv"])]
    log(f"2-layer full-width rwkv6-3b prefill + {steps} decode steps, kernel "
        f"vs plain path: worst logits max_abs {worst['max_abs']:.3e} mean_abs "
        f"{worst['mean_abs']:.3e} (tol {E2E_TOL}), logit std "
        f"{float(lp[..., :V].float().std()):.3f}; WKV state max_abs by layer "
        f"{['%.3e' % e for e in state_diff]} (state max "
        f"{max(float(s.abs().max()) for s in cp['wkv']):.3f})")
    if worst["max_abs"] > E2E_TOL["max_abs"] or \
            worst["mean_abs"] > E2E_TOL["mean_abs"]:
        raise AssertionError("rwkv6-3b: kernel path and plain path disagree")


# --------------------------------------------------------------------------- #
# Phase 5: train llama3.1-8b (8 of 32 layers) on the card
# --------------------------------------------------------------------------- #
def expected_train_launches(cfg, steps: int) -> dict:
    """Launches of each kernel in ``steps`` training steps: every layer runs
    under an activation checkpoint, so its flash attention, norms and
    grouped GEMMs (3 a MoE layer) run forward twice (the forward, the
    recompute in the backward) and backward once (each GEMM one dgrad and
    one wgrad); the final norm once each way.  A LayerNorm model
    (nemotron-4-15b) launches no RMSNorm kernel."""
    L = cfg.n_layers
    norms, final = rmsnorms(cfg)        # ln1, ln2 (q, k); none if LayerNorm
    gemms = 3 * (L - cfg.moe.first_k_dense) if cfg.moe else 0
    return {"flash_attention_fwd": 2 * L * steps,
            "rmsnorm_fwd": (2 * norms * L + final) * steps,
            "moe_gemm_fwd": 2 * gemms * steps, "wkv6_fwd": 0,
            "flash_attention_bwd": L * steps,
            "rmsnorm_bwd": (norms * L + final) * steps,
            "moe_gemm_dgrad": gemms * steps, "moe_gemm_wgrad": gemms * steps}


class GradientCheck:
    """Every parameter leaf has a finite, non-zero gradient after each
    step, and each layer's slice of a stacked leaf too (a detached kernel
    output would leave the layers below it at zero); the routed experts'
    leaves (layers, experts, ...) each expert's slice of each layer, where
    an expert that was routed no token has a zero slice: those are counted
    (``idle_experts``: the most over the gradient leaves' counts, each
    step), not failed, but each layer must have a routed expert.  One
    process calls it as a ``Trainer`` hook; on a mesh every rank calls
    ``check`` after each step, and a leaf split over ``model`` is held as
    one device holds it: its maxima are taken over the model group first
    (a leaf split over the experts gathers its per-expert maxima, so that
    each layer is held over all its experts; a vocabulary block has no
    gradient where the batch draws no token of it); each rank checks its
    own block over ``data``; the ranks' findings are gathered, so that all
    raise together and none is left waiting in a collective."""

    def __init__(self):
        self.step_times = []
        self.idle_experts = []

    def __call__(self, step, metrics, trainer) -> None:
        torch.cuda.synchronize()
        self.step_times.append(time.perf_counter())
        self.check(step, trainer)

    def check(self, step, trainer) -> None:
        from repro_torch.parallel.tensor import all_gather_dim
        fsdp = trainer.fsdp
        group = fsdp.model_group if fsdp is not None else None
        split = [p.mdim >= 0 for _, p in flatten_with_paths(fsdp.placements)
                 ] if group is not None else None
        moe = trainer.cfg.model.moe
        bad, idle = [], 0
        for i, (key, t) in enumerate(flatten_with_paths(trainer.state.params)):
            g = t.grad
            if g is None:
                bad.append(f"{key}: no gradient")
                g = torch.zeros_like(t)     # the gathers below stay paired
            expert = "/ffn/w" in key and g.dim() == 4
            per = (g.flatten(2).abs().amax(2) if expert
                   else g.flatten(1).abs().amax(1) if key.startswith("g")
                   else g.abs().amax().reshape(1))
            if expert and per.shape[1] != moe.n_experts:    # a block of them
                per = all_gather_dim(per.contiguous(), 1, group)
            elif split and split[i]:
                torch.distributed.all_reduce(
                    per, torch.distributed.ReduceOp.MAX, group)
            if not bool(torch.isfinite(per).all()):
                bad.append(f"{key}: non-finite")
            if expert:      # count idle experts, then every layer's slice
                idle = max(idle, int((per == 0).sum()))
                per = per.amax(1)
            if not bool((per > 0).all()):
                bad.append(f"{key}: zero in slices "
                           f"{(~(per > 0)).nonzero().flatten().tolist()}")
        if torch.distributed.is_initialized():
            found = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(found, bad)
            bad = [f"rank {r}: {b}" for r, bs in enumerate(found) for b in bs]
        self.idle_experts.append(idle)
        if bad:
            raise AssertionError(f"step {step}: " + "; ".join(bad))


def train(args, setup=TRAIN) -> tuple:
    """Train a full-width model cut to ``setup["layers"]`` layers (phase 5:
    llama3.1-8b; 5c: deepseek-v3-16b) through ``Trainer`` with the Lit
    Silicon hook; returns (launch counts, counts by path, losses) of the
    trained steps."""
    full = get_config(setup["arch"])
    cfg = full.replace(n_layers=setup["layers"])
    B, S, steps = setup["batch"], setup["seq"], setup["steps"]
    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoints"
    tc = TrainerConfig(
        model=cfg,
        train=TrainConfig(lr=setup["lr"], warmup_steps=1, total_steps=steps,
                          checkpoint_every=0, checkpoint_dir=str(ck / "full"),
                          seed=args.seed),
        data=DataConfig(global_batch=B, seq_len=S, seed=args.seed))
    hook = LitSiliconHook(      # as launch/train.py: the FULL arch workload
        full, ManagerConfig(use_case="gpu-red", sampling_period=2, warmup=3,
                            window_size=2), preset="mi300x")
    grads = GradientCheck()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(tc, hooks=[hook, grads], device="cuda")
    trainer.init_or_restore()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(trainer.state.params))
    moe = (f"; MoE layers {cfg.n_layers - cfg.moe.first_k_dense} of "
           f"{cfg.moe.n_experts} experts of {cfg.moe.d_expert}, top-"
           f"{cfg.moe.top_k} {cfg.moe.router}, {cfg.moe.n_shared} shared, "
           f"capacity {moe_mod.capacity(cfg, B * S)}" if cfg.moe else "")
    win = (f"; sliding window {cfg.window}: "
           f"{window_pairs(S, cfg.window) / (S * (S + 1) / 2):.1%} of the "
           f"causal pairs visible" if cfg.window else "")
    log(f"train {cfg.name} cut to {cfg.n_layers} of {full.n_layers} layers: "
        f"d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm}, {cfg.activation}"
        f"{moe}{win}; {n_params / 1e9:.3f} B "
        f"fp32 params + 2 fp32 moments made on the card in "
        f"{time.perf_counter() - t0:.1f} s; B {B} x S {S}, bf16 compute, "
        f"AdamW lr {setup['lr']}, gpu-red hook")

    log(f"launch counts before the run: "
        f"{ {k.__name__: k.launches for k in KERNELS} }; set to 0")
    for k in KERNELS:
        _build.reset_counts(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.run(steps)                    # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    by_path = {k.__name__: dict(k.launches_by_path) for k in KERNELS}
    log(f"trained {steps} steps in {wall:.2f} s; launch counts after the "
        f"run: {launches}, by path: {by_path}")
    losses = [m["loss"] for m in metrics]
    log(f"  losses {['%.4f' % x for x in losses]}; grad norms "
        f"{['%.3f' % m['grad_norm'] for m in metrics]}; lr "
        f"{['%.2e' % m['lr'] for m in metrics]}")
    log(f"  hook: sim node power {metrics[-1]['sim/node_power']:.1f} W, "
        f"freq {metrics[-1]['sim/freq_min']:.3f}-"
        f"{metrics[-1]['sim/freq_max']:.3f}, caps "
        f"{np.round(hook.backend.get_power_caps(), 1).tolist()}, "
        f"{len(hook.manager.adjust_log)} adjustments")
    if len(metrics) != steps or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training: {len(metrics)} steps, losses "
                             f"{losses}: not finite and falling")
    for name, want in expected_train_launches(cfg, steps).items():
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"training, expected {want}")
    for name, paths in by_path.items():
        if paths[SERVED_PATH[name]] != launches[name]:
            raise AssertionError(f"{name}: {paths} of {launches[name]} "
                                 f"launches; all must take the "
                                 f"{SERVED_PATH[name]} path")
    dts = np.diff([t0] + grads.step_times) * 1e3
    step_ms = float(np.median(dts[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{cfg.name}: {step_ms:.1f} ms/step (median of steps 2-{steps}; "
        f"step 1 {dts[0]:.1f} ms; all {['%.1f' % x for x in dts]}) = "
        f"{B * S * 1e3 / step_ms:.0f} tokens/s; peak memory {peak:.2f} GB; "
        f"{CARD}")
    if cfg.moe:
        n_moe = cfg.n_layers - cfg.moe.first_k_dense
        log(f"  experts that were routed no token, of {cfg.moe.n_experts * n_moe}"
            f" ({cfg.moe.n_experts} in each of {n_moe} MoE layers), by step: "
            f"{grads.idle_experts}")
    device_profile(f"{cfg.name} train step", step_ms,
                   lambda: trainer.run(1), top=10)
    del trainer, metrics
    torch.cuda.empty_cache()
    if setup is TRAIN:
        checkpoint_round_trip(ck / "reduced")
    return launches, by_path, losses


def adamw_blocks_ab(args) -> None:
    """Phases 5 and 5c with ``adamw_update`` walking each leaf in blocks of
    ``optimizer.PIECE`` elements (the default) and over whole leaves (PIECE
    past every leaf), in the order blocks, whole, whole, blocks: each run's
    ms/step, busy share and peak are train()'s lines."""
    piece = optimizer.PIECE
    try:
        for setup in (TRAIN, TRAIN_MOE):
            for arm in ("blocks", "whole", "whole", "blocks"):
                optimizer.PIECE = piece if arm == "blocks" else 1 << 62
                log(f"AdamW A/B, {setup['arch']}: {arm} (PIECE "
                    f"{optimizer.PIECE})")
                train(args, setup)
    finally:
        optimizer.PIECE = piece


def checkpoint_round_trip(directory: Path) -> None:
    """A reduced bf16 llama trained 4 steps on the card with a checkpoint
    every 2; a new trainer restores step 4 bit for bit and trains on."""
    import shutil
    from repro_torch.configs import get_reduced_config
    shutil.rmtree(directory, ignore_errors=True)
    tc = TrainerConfig(
        model=get_reduced_config("llama3.1-8b"),
        train=TrainConfig(lr=3e-3, warmup_steps=1, total_steps=8,
                          checkpoint_every=2, checkpoint_dir=str(directory)),
        data=DataConfig(global_batch=4, seq_len=64))
    first = Trainer(tc, device="cuda")
    first.run(4)
    first.ckpt.wait()
    second = Trainer(tc, device="cuda")
    second.init_or_restore()
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(second.state), tree_leaves(first.state)))
    log2 = second.run(2)
    second.ckpt.wait()
    log(f"checkpoint round trip on the card (reduced llama3.1-8b, bf16): "
        f"restored step {second.step - 2}, state equal {same}, then loss "
        f"{log2[-1]['loss']:.4f}; files {sorted(p.name for p in directory.iterdir())}")
    if second.step != 6 or not same or not np.isfinite(log2[-1]["loss"]):
        raise AssertionError("checkpoint round trip on the card failed")
    shutil.rmtree(directory, ignore_errors=True)


@contextmanager
def replayed_routes(routes):
    """Route each call to the experts ``routes`` holds (the idx of another
    run's routing calls, in order), the gates and aux from this run's
    scores at them: a path whose bf16 roundings move a near-tied k-th score
    still sends every token where the recorded run did."""
    calls = iter(routes)
    route = moe_mod._route          # what this run would route (recorded)

    def replay(cfg, logits):
        m = cfg.moe
        route(cfg, logits)
        idx = next(calls)
        scores, probs = moe_mod._scores(cfg, logits)
        gates = scores.gather(-1, idx)
        counts = torch.zeros(m.n_experts, device=logits.device).index_add_(
            0, idx.reshape(-1), torch.ones(idx.numel(), device=logits.device))
        return (gates / (gates.sum(-1, keepdim=True) + 1e-9), idx,
                moe_mod._aux(cfg, counts / (idx.shape[0] * m.top_k),
                             probs.mean(0)))

    with mock.patch.object(moe_mod, "_route", replay):
        yield


def train_kernel_vs_plain(args, arch: str = TRAIN["arch"], B: int = 2,
                          S: int = 2048) -> None:
    """Loss and every gradient leaf of a 2-layer full-width cut (deepseek:
    the dense layer and one MoE layer), kernel path against plain path, on
    the same parameters and batch; the plain path routes every token to
    the experts the kernel path chose (the share it would have sent
    elsewhere is printed)."""
    cfg = get_config(arch).replace(n_layers=2)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_train_params(gen, "cuda")
    data = SyntheticTokens(DataConfig(global_batch=B, seq_len=S,
                                      seed=args.seed), cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    results, routes = [], []
    for plain in (False, True):
        for t in tree_leaves(params):
            t.grad = None
        with plain_path() if plain else nullcontext(), \
                recorded_routes() as seen:
            with replayed_routes(routes[0]) if plain and cfg.moe \
                    else nullcontext():
                loss, _ = model.loss(params, batch)
                loss.backward()
        routes.append(seen)
        results.append((float(loss.detach()),
                        [t.grad for t in tree_leaves(params)]))
    (lk, gk), (lp, gp) = results
    if cfg.moe:
        flips = max(float((a != b).any(-1).float().mean())
                    for a, b in zip(*routes))
        log(f"2-layer {arch} training: the plain path's own routing would "
            f"send {flips:.2%} of the tokens (the most in a routing call) to "
            f"another expert set; it routed as the kernel path did")
    rows = []
    for (key, _), a, b in zip(flatten_with_paths(params), gk, gp):
        scale = float(b.abs().max())
        rows.append((key, float((a - b).abs().max()) / scale,
                     float((a - b).abs().mean()) / float(b.abs().mean())))
    worst_max = max(r[1] for r in rows)
    worst_mean = max(r[2] for r in rows)
    log(f"2-layer full-width {arch} training (B {B} x S {S}), kernel vs "
        f"plain path: loss {lk:.5f} vs {lp:.5f}; gradients, worst over "
        f"{len(rows)} leaves: max_abs/max {worst_max:.3e}, mean_abs/mean "
        f"{worst_mean:.3e} (tol {TRAIN_TOL})")
    for key, mx, mn in rows:
        log(f"  {key}: {mx:.3e} {mn:.3e}")
    if abs(lk - lp) > TRAIN_TOL["loss"] or worst_max > TRAIN_TOL["max_rel"] \
            or worst_mean > TRAIN_TOL["mean_rel"]:
        raise AssertionError("training: kernel path and plain path disagree")
    del params, results, gk, gp
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# Phase 5b: FSDP training over the machine's cards
# --------------------------------------------------------------------------- #
def fsdp_setups(world: int) -> list:
    """Phase 5's configuration, then phase 5c's (at a world of 1 only its
    first FSDP_MOE_STEPS_WORLD1 steps); at a world of 8 both at full depth
    with global batch 8 x S 4096."""
    if world == 8:
        return [dict(t, layers=get_config(t["arch"]).n_layers, batch=8)
                for t in (TRAIN, TRAIN_MOE)]
    moe = dict(TRAIN_MOE, steps=FSDP_MOE_STEPS_WORLD1,
               total_steps=TRAIN_MOE["steps"]) if world == 1 \
        else dict(TRAIN_MOE)
    return [dict(TRAIN), moe]


def mesh_worker(rank: int, world: int, port: int, seed: int, card: str,
                out: str, model_parallel: list, setups=None) -> None:
    """One rank of phase 5b or 5d (spawned): for each size of the ``model``
    axis, the host mesh of that shape and phase 5's and 5c's
    configurations (or ``setups``) through the sharded trainer; on a
    (world, 1) mesh of two or more ranks each twice, gathering ahead (the
    default) and in place (``FSDP(prefetch=False)``), the second held to
    the first bit for bit; rank 0 prints and writes the results to
    ``out``."""
    global CARD
    CARD = card
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.parallel.mesh import make_host_mesh
    results = {}
    try:
        for m in model_parallel:
            mesh = make_host_mesh(model_parallel=m)
            for setup in setups or fsdp_setups(world):
                key = f"{setup['arch']} {world // m}x{m}"
                ab = m == 1 and world > 1             # phase 5b's A/B
                results[key], state = _fsdp_run(rank, world, seed, mesh,
                                                 setup, keep=ab)
                torch.cuda.empty_cache()
                if ab:
                    results[key + " in place"], _ = _fsdp_run(
                        rank, world, seed, mesh, setup, prefetch=False,
                        against=(results[key], state))
                del state
                torch.cuda.empty_cache()
    except BaseException:
        # the other ranks may wait in a collective, where tearing the group
        # down would hang and hide this: report and leave at once
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    torch.distributed.destroy_process_group()
    if rank == 0:
        Path(out).write_text(json.dumps(results))


def state_digest(state) -> dict:
    """Checkpoint key -> (the sum of the leaf's bit patterns as int32 words,
    its fp64 sum): equal digests for states equal bit for bit."""
    return {k: (int(v.detach().contiguous().view(torch.int32)
                    .sum(dtype=torch.int64)), float(v.detach().double().sum()))
            for k, v in flatten_with_paths(state)}


def collectives_by_group(coll: float, nccl: float, D: int, M: int) -> str:
    """The device time of a step's collectives split into the model
    group's and the data group's where the mesh tells them apart: a group
    of one rank copies instead of launching NCCL kernels, so on a (D, 1)
    mesh every NCCL kernel is the data group's, on a (1, M) mesh the model
    group's (the data group's copies are the rest of the ``nccl:*``
    time).  Where both groups span ranks, their kernels share NCCL's
    stream and names, and the split is not read."""
    if M == 1:
        return f"by group: model 0.00 ms, data {coll:.2f} ms"
    if D == 1:
        return (f"by group: model {nccl:.2f} ms (the NCCL kernels), data "
                f"{coll - nccl:.2f} ms (copies)")
    return "by group: not split (both groups launch NCCL kernels)"


def _fsdp_run(rank, world, seed, mesh, setup, prefetch=True, keep=False,
              against=None) -> tuple:
    """One configuration through the sharded trainer on ``mesh``, gathering
    each layer a layer ahead (``prefetch``, the default path) or in place;
    ``against``: (the results, the host copy of the state) of the same
    configuration's other arm, which this run's losses, grad norms and
    every leaf of the state must equal bit for bit (every rank holds its
    shards, and all raise together).  Returns (rank 0's results, the
    others None; with ``keep`` the host copy of this rank's state)."""
    from torch.autograd import DeviceType
    from repro_torch.configs import ParallelConfig
    from repro_torch.parallel.fsdp import FSDP
    cfg = get_config(setup["arch"]).replace(n_layers=setup["layers"])
    B, S, steps = setup["batch"], setup["seq"], setup["steps"]
    D, M = mesh.size(0), mesh.size(1)
    what = f"mesh {D}x{M}" + ("" if prefetch else " in place")
    tc = TrainerConfig(
        model=cfg,
        train=TrainConfig(lr=setup["lr"], warmup_steps=1,
                          total_steps=setup.get("total_steps", steps),
                          checkpoint_every=0, seed=seed,
                          checkpoint_dir=str(Path(__file__).resolve().parent
                                             / "build" / "chip_smoke_fsdp")),
        parallel=ParallelConfig(**setup.get("parallel", {})),
        data=DataConfig(global_batch=B, seq_len=S, seed=seed))
    grads = GradientCheck()
    hooks = [LitSiliconHook(get_config(setup["arch"]), ManagerConfig(
        use_case="gpu-red", sampling_period=2, warmup=3, window_size=2),
        preset="mi300x")] if rank == 0 else []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(tc, hooks=hooks, device="cuda", mesh=mesh)
    if not prefetch:
        trainer.fsdp = FSDP(trainer.model, mesh, tc.parallel, "cuda",
                            prefetch=False)
    trainer.init_or_restore()
    torch.cuda.synchronize()
    if rank == 0:
        n = sum(int(np.prod(p.shape)) for p in
                tree_leaves(trainer.fsdp.placements))
        log(f"{what}: world {world} (NCCL, one process per card; ZeRO-3 "
            f"over data {D}, tensor/sequence/expert parallel over model "
            f"{M}), {cfg.name} {cfg.n_layers} layers, {n / 1e9:.3f} B fp32 "
            f"params sharded with both moments, made in "
            f"{time.perf_counter() - t0:.1f} s; global batch {B} x S {S}, "
            f"{B // D if B % D == 0 else B} rows a data rank, "
            f"{S // M if M > 1 else S} of the residual stream's positions "
            f"a model rank; gathers "
            f"{'a layer ahead' if prefetch else 'in place'}"
            f"{'; ' + str(tc.parallel) if setup.get('parallel') else ''}")
    for k in KERNELS:
        _build.reset_counts(k)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dts = []
    for _ in range(steps):          # the main path, checked after each step
        t1 = time.perf_counter()
        metrics = trainer.run(1)    # the log of every step so far
        torch.cuda.synchronize()
        dts.append((time.perf_counter() - t1) * 1e3)
        grads.check(trainer.step - 1, trainer)
    wall = time.perf_counter() - t0
    # before the profiled step below
    digest = state_digest(trainer.state) if setup.get("digest") else None
    launches = {k.__name__: k.launches for k in KERNELS}
    by_path = {k.__name__: dict(k.launches_by_path) for k in KERNELS}
    for name, want in expected_train_launches(cfg, steps).items():
        if launches[name] != want:
            raise AssertionError(f"{what} rank {rank}: {name} "
                                 f"{launches[name]} launches, expected "
                                 f"{want}")
    for name, paths in by_path.items():
        if paths[SERVED_PATH[name]] != launches[name]:
            raise AssertionError(f"{what} rank {rank}: {name}: {paths}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ranks = [None] * world
    torch.distributed.all_gather_object(ranks, (launches, by_path, peak))
    if rank == 0:
        step_ms = float(np.median(dts[1:]))
        losses = [m["loss"] for m in metrics]
        log(f"{what} {cfg.name}: {steps} steps in {wall:.2f} s; losses "
            f"{['%.4f' % x for x in losses]}; grad norms "
            f"{['%.3f' % m['grad_norm'] for m in metrics]}")
        if cfg.moe:
            log(f"{what} {cfg.name}: experts routed no token (of "
                f"{cfg.moe.n_experts} a layer, over the model group), by "
                f"step: {grads.idle_experts}")
        log(f"{what} {cfg.name}: {step_ms:.1f} ms/step (median "
            f"of steps 2-{steps}; all {['%.1f' % x for x in dts]}) = "
            f"{B * S * 1e3 / step_ms:.0f} tokens/s; peak memory per card "
            f"{['%.2f' % r[2] for r in ranks]} GB; launches per rank "
            f"{launches}; {CARD}")
    prof, busy = (device_profile(f"{what} {cfg.name} step", step_ms,
                                 lambda: trainer.run(1), top=10)
                  if rank == 0 else (None, 0.0))
    if rank != 0:
        trainer.run(1)                  # the profiled step runs everywhere
    ahead = dict(trainer.fsdp.prefetch_stats)
    sums = [{k: m[k] for k in ("loss", "ce_loss", "z_loss", "aux_loss",
                               "grad_norm") if k in m} for m in metrics]
    state = None
    if keep or against is not None:
        state = {k: v.detach().cpu() for k, v in
                 flatten_with_paths(trainer.state)}
    if against is not None:
        bad = [k for k, v in state.items()
               if not torch.equal(v, against[1][k])]
        found = [None] * world
        torch.distributed.all_gather_object(found, bad)
        bad = [f"rank {r}: {k}" for r, ks in enumerate(found) for k in ks]
        if rank == 0:
            same = sums == against[0]["sums"]
            log(f"{what} {cfg.name} against gathering ahead (same ranks "
                f"and seed): losses and grad norms of {len(sums)} steps "
                f"{'equal' if same else 'DIFFER'}; state leaves that differ "
                f"(torch.equal over every rank's shards of the parameters "
                f"and both moments): {len(bad)} of {len(state) * world}")
            bad += [] if same else ["losses"]
        if bad:
            raise AssertionError(f"{what} {cfg.name}: gathering in place "
                                 f"differs from gathering ahead: {bad[:8]}")
    if rank != 0:
        return None, state
    # c10d's annotation of each collective on the device timeline: the
    # device time of what NCCL ran for it (kernels; copies at world 1)
    ranges = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.is_user_annotation
              and e.key.startswith("nccl:")}
    nccl = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and "nccl" in e.key.lower())
    coll = sum(ranges.values())
    streams_ms, over, exposed, streams = collective_overlap(prof)
    log(f"{what} {cfg.name} collectives in a step (rank 0): "
        f"{coll:.2f} ms of device time "
        f"{ {k: round(v, 3) for k, v in ranges.items()} } (NCCL kernels "
        f"{nccl:.2f} ms); {collectives_by_group(coll, nccl, D, M)}; busy "
        f"{busy:.2f} of {step_ms:.2f} ms ({100 * busy / step_ms:.1f}%); "
        f"{CARD}")
    log(f"{what} {cfg.name} overlap (rank 0's profiled step): "
        f"collectives {streams_ms:.2f} ms of device time, of it "
        f"{over:.2f} ms overlapped by compute kernels and "
        f"{exposed:.2f} ms exposed (busy ms by stream, c: collective only "
        f"{streams}); layers gathered ahead {ahead['layers']}"
        f" (at most {ahead['most_ahead']} at a time); {step_ms:.1f} "
        f"ms/step, busy {100 * busy / step_ms:.1f}%, peak "
        f"{max(r[2] for r in ranks):.2f} GB a card; {CARD}")
    return {
        "losses": losses, "step_ms": step_ms, "peak_gb": [r[2] for r in ranks],
        "busy_ms": busy, "collective_ms": coll, "nccl_ms": nccl,
        "overlapped_ms": over, "exposed_ms": exposed, "ahead": ahead,
        "sums": sums, "digest": digest,
        "launches": {k: sum(r[0][k] for r in ranks) for k in launches},
        "by_path": {k: {p: sum(r[1][k][p] for r in ranks) for p in v}
                    for k, v in by_path.items()}}, state


def spawn_meshes(args, world: int, model_parallel: list, timeout: float,
                 name: str, setups=None) -> dict:
    """``mesh_worker`` over ``world`` spawned ranks (NCCL), with a deadline;
    returns rank 0's results."""
    import shutil
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    build = Path(__file__).resolve().parent / "build"
    shutil.rmtree(build / "chip_smoke_fsdp", ignore_errors=True)
    out = build / f"chip_smoke_{name}.json"
    out.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    ctx = mp.start_processes(mesh_worker, args=(world, port, args.seed, CARD,
                                                str(out), model_parallel,
                                                setups),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"{name}: world {world} did not finish "
                                     f"in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return json.loads(out.read_text())


def fsdp_train(args, unsharded: dict) -> tuple:
    """Phase 5b: the FSDP trainer over every card (at most 8), one spawned
    process each, on the (world, 1) mesh, through the same 2-D code as
    phase 5d (at a world of 1 the (1, 1) mesh: no ``model`` collective
    runs); phase 5's and phase 5c's configurations; at a world of 1 each
    run's losses held to the unsharded run's (``unsharded``: arch ->
    losses): llama's within FSDP_LOSS_TOL, the MoE run's bit for bit; at a
    world of 2 or more each configuration also gathering in place, held to
    the default path (gathering a layer ahead) bit for bit.  Returns
    ({run: (launch counts, counts by path)} summed over the ranks, of the
    default path, {arch: losses})."""
    world = min(torch.cuda.device_count(), 8)
    runs, losses = {}, {}
    results = spawn_meshes(args, world, [1], FSDP_TIMEOUT_S, "fsdp")
    for key, res in results.items():
        arch = key.split()[0]
        if key.endswith(" in place"):
            ahead = results[key[:-len(" in place")]]
            log(f"fsdp world {world} {arch}, gathering a layer ahead | in "
                f"place (one call, same ranks and seed, equal bit for bit): "
                f"{ahead['step_ms']:.1f} | {res['step_ms']:.1f} ms/step, "
                f"busy {100 * ahead['busy_ms'] / ahead['step_ms']:.1f} | "
                f"{100 * res['busy_ms'] / res['step_ms']:.1f}%, "
                f"collectives {ahead['overlapped_ms'] + ahead['exposed_ms']:.2f}"
                f" | {res['overlapped_ms'] + res['exposed_ms']:.2f} ms, of "
                f"it overlapped {ahead['overlapped_ms']:.2f} | "
                f"{res['overlapped_ms']:.2f} and exposed "
                f"{ahead['exposed_ms']:.2f} | {res['exposed_ms']:.2f} ms, "
                f"peak {max(ahead['peak_gb']):.2f} | "
                f"{max(res['peak_gb']):.2f} GB a card; {CARD}")
            continue
        if world == 1:
            # llama: within FSDP_LOSS_TOL; the MoE run bit for bit
            want = unsharded[arch][:len(res["losses"])]
            tol = FSDP_LOSS_TOL if arch == TRAIN["arch"] else 0.0
            diff = max(abs(a - b) / abs(b)
                       for a, b in zip(res["losses"], want))
            log(f"fsdp world 1 {arch} against the unsharded run (same seed): "
                f"losses {res['losses']} vs {want}, largest difference "
                f"{diff:.3e} of the loss (tol {tol})")
            if len(res["losses"]) != len(want) or diff > tol:
                raise AssertionError(f"fsdp: world 1 and the unsharded "
                                     f"trainer disagree on {arch}")
        if not all(np.isfinite(res["losses"])) \
                or not res["losses"][-1] < res["losses"][0]:
            raise AssertionError(f"fsdp {arch}: losses {res['losses']} not "
                                 f"finite and falling")
        runs[f"{arch} fsdp"] = (res["launches"], res["by_path"])
        losses[arch] = res["losses"]
    return runs, losses


def int8_train(args) -> dict:
    """Phase 5e: int8 gradient compression with error feedback, 3 steps of
    phase 5b's world-1 MoE configuration (phase 5c's, which 5b holds bit
    for bit) with ``grad_compression="int8"``: unsharded in this process,
    then through FSDP over an NCCL group of one (a spawned rank, its
    gathers a layer ahead); the losses, grad norms and every leaf of the
    state (parameters, both moments, the error) equal bit for bit, the
    error finite.  Returns {run: (launch counts, counts by path)}."""
    from repro_torch.configs import ParallelConfig
    setup = dict(TRAIN_MOE, steps=INT8_STEPS, total_steps=TRAIN_MOE["steps"],
                 parallel={"grad_compression": "int8"}, digest=True)
    cfg = get_config(setup["arch"]).replace(n_layers=setup["layers"])
    tc = TrainerConfig(
        model=cfg,
        train=TrainConfig(lr=setup["lr"], warmup_steps=1,
                          total_steps=setup["total_steps"], checkpoint_every=0,
                          seed=args.seed,
                          checkpoint_dir=str(Path(__file__).resolve().parent
                                             / "build" / "chip_smoke_int8")),
        parallel=ParallelConfig(**setup["parallel"]),
        data=DataConfig(global_batch=setup["batch"], seq_len=setup["seq"],
                        seed=args.seed))
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        _build.reset_counts(k)
    trainer = Trainer(tc, device="cuda")
    metrics = trainer.run(setup["steps"])            # the main path
    torch.cuda.synchronize()
    runs = {f"{cfg.name} int8": (
        {k.__name__: k.launches for k in KERNELS},
        {k.__name__: dict(k.launches_by_path) for k in KERNELS})}
    for name, n in expected_train_launches(cfg, setup["steps"]).items():
        if runs[f"{cfg.name} int8"][0][name] != n:
            raise AssertionError(f"int8 {name}: {runs[f'{cfg.name} int8'][0]}"
                                 f" launches, expected {n}")
    want = [[m[k] for k in ("loss", "grad_norm")] for m in metrics]
    digest = state_digest(trainer.state)
    finite = all(bool(torch.isfinite(e).all())
                 for e in tree_leaves(trainer.state.err))
    err_max = max(float(e.abs().max()) for e in tree_leaves(trainer.state.err))
    log(f"int8 {cfg.name} {cfg.n_layers} layers unsharded: losses and grad "
        f"norms {want}; error finite {finite}, largest |err| {err_max:.3e}; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {CARD}")
    del trainer, metrics
    torch.cuda.empty_cache()
    res = spawn_meshes(args, 1, [1], FSDP_TIMEOUT_S, "int8", [setup])
    (key, got), = res.items()
    same = ([[s["loss"], s["grad_norm"]] for s in got["sums"]][:len(want)]
            == want and got["digest"] == {k: list(v)
                                          for k, v in digest.items()})
    log(f"int8 {cfg.name} through FSDP at world 1 ({key}) against the "
        f"unsharded int8 run: losses, grad norms and all {len(digest)} "
        f"state leaves' digests {'equal' if same else 'DIFFER'}")
    if not (same and finite):
        raise AssertionError(f"int8: FSDP at world 1 and the unsharded "
                             f"trainer disagree, or the error is not finite")
    runs[f"{cfg.name} int8 fsdp"] = (got["launches"], got["by_path"])
    return runs


def tp_meshes(world: int) -> list:
    """Phase 5d's sizes of the ``model`` axis: (world/2, 2) and (1, world)."""
    return sorted({2, world}) if world >= 2 else []


def tp_train(args, fsdp_losses: dict) -> dict:
    """Phase 5d: tensor, sequence and expert parallelism over the ``model``
    axis, on the (world/2, 2) and (1, world) meshes over every card, phase
    5b's configurations; each step's loss held to phase 5b's at the same
    world (``fsdp_losses``) within TP_LOSS_TOL.  A world of 1 has no
    ``model`` axis above 1 (NCCL puts no two ranks of one communicator on
    one card): the phase is left out there.  Returns {run: (launch counts,
    counts by path)} summed over the ranks."""
    world = min(torch.cuda.device_count(), 8)
    if world < 2:
        log(f"phase 5d: {world} card; a model axis above 1 needs two or "
            f"more, so the phase is left out on this machine")
        return {}
    runs = {}
    for key, res in spawn_meshes(args, world, tp_meshes(world), TP_TIMEOUT_S,
                                 "tp").items():
        arch = key.split()[0]
        want = fsdp_losses[arch]
        diff = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], want))
        log(f"{key} against phase 5b's world {world} run (same seed): "
            f"losses {res['losses']} vs {want}, largest difference "
            f"{diff:.3e} of the loss (tol {TP_LOSS_TOL})")
        if len(res["losses"]) != len(want) or diff > TP_LOSS_TOL:
            raise AssertionError(f"tp {key}: losses off phase 5b's")
        if not all(np.isfinite(res["losses"])) \
                or not res["losses"][-1] < res["losses"][0]:
            raise AssertionError(f"tp {key}: losses {res['losses']} not "
                                 f"finite and falling")
        runs[f"{arch} tp {key.split()[1]}"] = (res["launches"],
                                               res["by_path"])
    return runs


# --------------------------------------------------------------------------- #
# Phase 6: device times of the redesigned and the backward kernels
# --------------------------------------------------------------------------- #
def backward_device_times(g, rows: dict, rounds: int = 3) -> None:
    """Device time alone of the backward kernels at their training shapes
    (flash: the wgmma kernels and the simt ones kept beside them; the
    grouped GEMM's dgrad and wgrad at wg / wu's E 64, C 960, d 2048, h
    1408), of their plain versions and of the library's backward (autograd
    of F.scaled_dot_product_attention and of F.rms_norm; torch.bmm of the
    same product), in ``rounds`` alternating rounds, their mean into the
    rows."""
    dev, bf = "cuda", torch.bfloat16
    q, do = (torch.randn(2, 4096, 32, 128, generator=g, device=dev).to(bf)
             for _ in range(2))
    k, v = (torch.randn(2, 4096, 8, 128, generator=g, device=dev).to(bf)
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    x, dy = (torch.randn(8192, 4096, generator=g, device=dev).to(bf)
             for _ in range(2))
    w = torch.randn(4096, generator=g, device=dev)
    ex = torch.randn(64, 960, 2048, generator=g, device=dev).to(bf)
    ew = torch.randn(64, 2048, 1408, generator=g, device=dev).to(bf)
    edy = torch.randn(64, 960, 1408, generator=g, device=dev).to(bf)
    fa, rms = rows["flash_attention_bwd"], rows["rmsnorm_bwd"]
    dg, wg = rows["moe_gemm_dgrad"], rows["moe_gemm_wgrad"]
    timed = [   # (row, key, fn, kernels a call)
        (fa, "device_ms", lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=True), 3),
        (fa, "simt_device_ms", lambda: fa_kernel._launch_bwd(
            "simt", q, k, v, o, lse, do, causal=True, window=0, q_offset=0),
         3),
        (fa, "plain_device_ms", lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=True), 0),
        (fa, "library_device_ms", sdpa_backward(q, k, v, do), 0),
        (rms, "device_ms", lambda: rmsnorm_bwd(x, w, dy), 2),
        (rms, "plain_device_ms", lambda: rmsnorm_bwd_ref(x, w, dy), 0),
        (rms, "library_device_ms", rms_norm_backward(x, w, dy), 0),
        (dg, "device_ms", lambda: moe_gemm_dgrad(edy, ew), 1),
        (dg, "plain_device_ms", lambda: moe_gemm_dgrad_ref(edy, ew), 0),
        (dg, "library_device_ms", lambda: torch.bmm(edy, ew.transpose(1, 2)),
         0),
        (wg, "device_ms", lambda: moe_gemm_wgrad(ex, edy), 1),
        (wg, "plain_device_ms", lambda: moe_gemm_wgrad_ref(ex, edy), 0),
        (wg, "library_device_ms", lambda: torch.bmm(ex.transpose(1, 2), edy),
         0),
    ]
    reads = [[device_ms(fn, iters=5, kernels=n, flush=False)
              for _, _, fn, n in timed] for _ in range(rounds)]
    for (row, key, _, _), ms in zip(timed, zip(*reads)):
        row[key] = None if None in ms else sum(ms) / rounds
        log(f"{row['name']} {key[:-3]} (torch.profiler), ms: "
            + ", ".join("not measured" if t is None else f"{t:.4f}"
                        for t in ms) + f"; {CARD}")


def device_times(g, rows: dict, rounds: int = 3) -> None:
    """Device time alone (torch.profiler) of the redesigned RMSNorm and WKV6
    kernels at phase 2's main shapes, of the kernels kept beside them (the
    ones every call took before), of ``F.rms_norm`` and of the WKV6 decode
    state's copy (``copy_`` of the state in to the state out: the least a
    kernel that reads and writes the state takes under this flush), in
    ``rounds`` alternating rounds, their mean into the rows of the kernels
    line.  Taken after the served runs, since a profiler session slows the
    host launches that follow it."""
    dev, bf = "cuda", torch.bfloat16
    x = torch.randn(2048, 4096, generator=g, device=dev).to(bf)
    r = torch.randn(2048, 4096, generator=g, device=dev).to(bf)
    w = torch.randn(4096, generator=g, device=dev)
    wl, xd = w.to(bf), x[:4].clone()
    prefill = wkv_inputs(g, 4, 512, 40, 64, bf, False)
    decode = wkv_inputs(g, 4, 1, 40, 64, bf, True)
    s_copy = torch.empty_like(decode[-1])
    rms, wkv = rows["rmsnorm"], rows["wkv6"]
    timed = [   # (row, key, fn)
        (rms, "device_ms", lambda: rmsnorm_fwd(x, w)),
        (rms, "simt_device_ms", lambda: rms_kernel._launch("simt", x, w)),
        (rms, "library_device_ms", lambda: F.rms_norm(x, (4096,), wl, 1e-5)),
        (rms, "decode_device_ms", lambda: rmsnorm_fwd(xd, w)),
        (rms, "decode_simt_device_ms",
         lambda: rms_kernel._launch("simt", xd, w)),
        (rms, "residual_device_ms", lambda: rmsnorm_fwd(x, w, r)),
        (rms, "residual_simt_device_ms",
         lambda: rms_kernel._launch("simt", x, w, r)),
        (wkv, "device_ms", lambda: wkv6_fwd(*prefill)),
        (wkv, "simt_device_ms", lambda: wkv_kernel._launch("simt", *prefill)),
        (wkv, "decode_device_ms", lambda: wkv6_fwd(*decode)),
        (wkv, "decode_simt_device_ms",
         lambda: wkv_kernel._launch("simt", *decode)),
        (wkv, "decode_copy_device_ms", lambda: s_copy.copy_(decode[-1])),
    ]
    reads = [[device_ms(fn) for _, _, fn in timed] for _ in range(rounds)]
    for (row, key, _), ms in zip(timed, zip(*reads)):
        row[key] = None if None in ms else sum(ms) / rounds
        log(f"{row['name']} {key[:-3]} (torch.profiler, L2 flushed), us: "
            + ", ".join("not measured" if t is None else f"{t * 1e3:.3f}"
                        for t in ms) + f"; {CARD}")


def fleet_profile(walls: tuple) -> None:
    """Phase 7b's population once more under torch.profiler (after the
    host-clock phases): the device's busy share of its unprofiled warm
    call's time, and of its first call's, and the device time by kernel."""
    first, warm = walls
    spec, arrays = scan_population({}, FLEET["pop_samples"],
                                   FLEET["pop_nodes"], FLEET["iterations"],
                                   "summary")
    per = {S: launches_per_iteration(S, FLEET["pop_nodes"])
           for S in (FLEET["topo_samples"], FLEET["pop_samples"])}
    log(f"7b: launches an iteration of the scan (torch.profiler), "
        + ", ".join(f"S {k}: {v:g}" for k, v in per.items())
        + f" {'equal' if len(set(per.values())) == 1 else 'DIFFER'}")
    if len(set(per.values())) != 1:
        raise AssertionError("7b: the scan's launches an iteration depend on "
                             "the number of samples")
    prof, busy = device_profile(
        f"7b population ({FLEET['pop_samples']} x {FLEET['pop_nodes']} "
        f"nodes, over the warm call)", warm * 1e3,
        lambda: torch_engine.run_fleet_scan(spec, arrays), top=8)
    log(f"  over the first call's {first * 1e3:.2f} ms: busy "
        f"{100 * busy / (first * 1e3):.1f}%, idle "
        f"{100 - 100 * busy / (first * 1e3):.1f}%")
    from torch.autograd import DeviceType
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    log("  host time by operation (self, profiled, so slower than the "
        "unprofiled run):")
    for ms, count, key in host[:8]:
        log(f"  {ms:8.3f} ms  x{count:<6d} {key[:80]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--host-only", action="store_true",
                    help="phase 1 and the host cost per call only")
    ap.add_argument("--adamw-ab", action="store_true",
                    help="phase 1, then phases 5 and 5c with AdamW in "
                         "blocks and over whole leaves, alternated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card()
    build()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.host_only:
        print(json.dumps({"host_us": host_costs(g)}), flush=True)
        return 0
    if args.adamw_ab:
        adamw_blocks_ab(args)
        return 0
    rows = [flash_checks(g), rmsnorm_checks(g), moe_gemm_checks(g),
            wkv6_checks(g), flash_bwd_checks(g), rmsnorm_bwd_checks(g),
            *moe_gemm_bwd_checks(g), *window_flash_checks(g)]
    costs = host_costs(g)
    for row in rows:
        row.update(costs.get(row["name"], {}))
    rows.extend(c3_window_checks(g))
    # phase 7 runs here, before any profiler session (which would slow the
    # host clocks it reads)
    fleet_runs, pop_walls = fleet_sim(args)
    torch.cuda.empty_cache()
    by_run = {"llama3.1-8b": serve(args, "llama3.1-8b")}
    kernel_vs_plain(args)
    by_run["deepseek-v3-16b"] = serve(args, "deepseek-v3-16b")
    moe_kernel_vs_plain(args)
    by_run["rwkv6-3b"] = serve(args, "rwkv6-3b")
    rwkv_kernel_vs_plain(args)
    by_run["mistral-7b"] = serve(args, "mistral-7b", MISTRAL_PROMPT)  # 3m
    kernel_vs_plain(args, "mistral-7b", MISTRAL_PROMPT, args.new_tokens)
    for arch in SERVED_DENSE:                                       # 3d
        by_run[arch] = serve(args, arch)
    torch.cuda.empty_cache()
    losses = {}
    for setup in (TRAIN, TRAIN_MOE):                     # phases 5 and 5c
        launches, by_path, losses[setup["arch"]] = train(args, setup)
        by_run[f"{setup['arch']} train"] = (launches, by_path)
        train_kernel_vs_plain(args, setup["arch"])
    for setup in (TRAIN_MISTRAL, *TRAIN_DENSE):          # phases 5m and 5x
        launches, by_path, _ = train(args, setup)
        by_run[f"{setup['arch']} train"] = (launches, by_path)
        train_kernel_vs_plain(args, setup["arch"], setup["batch"],
                              setup["seq"])
    runs, fsdp_losses = fsdp_train(args, losses)
    by_run.update(runs)
    by_run.update(int8_train(args))                           # phase 5e
    by_run.update(tp_train(args, fsdp_losses))                # phase 5d
    by_name = {row["name"]: row for row in rows}
    device_times(g, by_name)
    backward_device_times(g, by_name)
    fleet_profile(pop_walls)
    # each row's kernel wrapper, and the runs whose launches it counts (the
    # windowed rows: those of the runs whose every flash launch is windowed)
    counted = {"flash_attention_window": (fa_ops.flash_attention_fwd,
                                          WINDOWED_RUNS),
               "flash_attention_bwd_window": (fa_ops.flash_attention_bwd,
                                              WINDOWED_RUNS)}
    for row, fn in zip(rows, KERNELS):
        counted[row["name"]] = (fn, tuple(by_run))
    by_run.update(fleet_runs)
    for row, fn in (("c3_window", c3_window_scan),
                    ("c3_window_draw", c3_window_draw_scan),
                    ("jax_normal", jax_normal_draw)):
        counted[row] = (fn, tuple(fleet_runs))
    for row in rows:
        fn, names = counted[row["name"]]
        name = fn.__name__
        counts = {run: by_run[run][0][name] for run in names}
        row["launches"] = sum(counts.values())
        row["launches_by_run"] = counts
        if hasattr(fn, "launches_by_path"):
            row["launches_by_path"] = {
                path: sum(by_run[run][1][name][path] for run in names)
                for path in fn.launches_by_path}
    for name in counted:
        if by_name[name]["launches"] == 0:
            raise AssertionError(f"{name}: launched no time on the main path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
