"""Chip smoke test of the PyTorch port on one NVIDIA card.

  python3 chip_smoke.py              # from the root of a checkout, one card
  python3 chip_smoke.py --host-only  # phase 1, then host us per call only

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
6. the device time alone (torch.profiler) of RMSNorm and WKV6, the new
   kernels and the ones kept beside them (L2 flushed), and of the two
   backward kernels, their plain versions and the library's backward, after
   the served and trained runs, whose host timings a profiler session would
   slow;
7. the JSON line of the kernels, then the JSON line of the device.

Phase 2 also holds the two backward kernels (flash attention's dQ, dK, dV
from the forward's log-sum-exp; RMSNorm's dx, dw) against their plain
versions and against autograd of the plain forward.

It needs ``src/repro_torch`` beside it, and CUDA; without either it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
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
from repro_torch.core.manager import ManagerConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_fwd  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
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
from repro_torch.train.train_loop import (LitSiliconHook, Trainer,  # noqa: E402
                                          TrainerConfig)

# H100 SXM data sheet (dense, 700 W): the card's least time for a function
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
           rms_ops.rmsnorm_bwd]
# the kernel every served or trained launch of each wrapper must take
SERVED_PATH = {"flash_attention_fwd": "wgmma", "rmsnorm_fwd": "vector",
               "moe_gemm_fwd": "wgmma", "wkv6_fwd": "split",
               "flash_attention_bwd": "simt", "rmsnorm_bwd": "simt"}
# backward kernels against their plain backward (same inputs, same lse) and
# against autograd of the plain forward: fp32 and bf16 relative to each
# gradient's largest magnitude (sums over many keys or rows; in bf16 the
# kernel rounds P for dV and each gradient once, as the plain backward does)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the training phase: full-width llama3.1-8b, 8 of 32 layers, B 2 x S 4096
TRAIN = dict(arch="llama3.1-8b", layers=8, batch=2, seq=4096, steps=10,
             lr=1e-3)
# kernel path vs plain path, loss and every gradient leaf of a 2-layer
# full-width bf16 cut: both round activations to bf16 at the same points
# and sum in another order, so values on a rounding boundary move one bf16
# step (2**-8 relative) and such flips compound through 2 layers and the
# backward: the mean as E2E_TOL's for the logits of the same cut (2% of
# unit-scale values; the forward alone differs by 0.76% there), the largest
# difference to 5% of a leaf's largest gradient; a detached kernel output
# would leave a leaf's gradient 100% off
TRAIN_TOL = {"loss": 1e-2, "max_rel": 5e-2, "mean_rel": 2e-2}
# the redesigned kernels' times before their wgmma redesign, by this script
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), at the shapes of phase 2:
# printed in the log beside this run's times, never in the kernels line
PREV_MS = {"flash_attention": {"ms": 0.5279},
           "moe_gemm": {"ms": 0.4996, "decode_ms": 0.1501}}


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


SENTINELS = 3      # kernels launched around the timed ones, then left out


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
                 "moe_gemm", "wkv6"):
        _build.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    for entry in _build.build_log:
        for line in entry.splitlines():
            if line.startswith("==") or "Used" in line or "spill" in line:
                log("  " + line.strip())
            elif "Compiling entry function" in line:   # the kernel, briefly
                log("  " + line.split("'")[1].split("_cu_")[-1][:70])
            elif "C75" in line:       # ptxas: wgmma serialized, and why
                log("  " + line.strip()[:160])


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
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    err = max(rel_err(a, b) for a, b in zip(grads, plain))
    log(f"  main shape B{B} S{S} H{H}/{kvH} D{D} bf16 causal: max rel_err "
        f"{err:.3e} against the plain backward (tol {BWD_TOL[dt]:g})")
    if err > BWD_TOL[dt]:
        raise AssertionError("flash backward, main shape")
    del plain
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=True), iters=5)
    plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
    lib = sdpa_backward(q, k, v, do)
    lib_ms = cuda_ms(lib, iters=5)
    nbytes = 2 * (3 * q.numel() + 4 * k.numel()) + lse.numel() * 4
    flops = 5 * B * H * S * S * D          # 5 products, the causal half
    b_ms, b_by = bound(nbytes, flops, dt)
    log(f"  main shape: kernel {ms:.3f} ms ({ms / b_ms:.1f}x its bound, "
        f"{ms / lib_ms:.1f}x sdpa's backward), plain {plain_ms:.3f} ms, "
        f"sdpa backward {lib_ms:.3f} ms, bound {b_ms * 1e3:.1f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP); {CARD}")
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/attention.py:152",
                replaces_note="no TPU kernel: XLA autodiff of sdpa_flash",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def sdpa_backward(q, k, v, do):
    """One autograd backward of F.scaled_dot_product_attention (causal, GQA)
    on q, k, v (B, S, H, D): the library's yardstick for flash's backward."""
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


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


# --------------------------------------------------------------------------- #
# Phase 3: serve llama3.1-8b, deepseek-v3-16b and rwkv6-3b
# --------------------------------------------------------------------------- #
def expected_launches(cfg, new_tokens: int) -> dict:
    """Launches of each kernel in one served run: prefill + new_tokens - 1
    decode steps, new_tokens forwards in all."""
    n_moe = (cfg.n_layers - cfg.moe.first_k_dense) if cfg.moe else 0
    no_backward = {"flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    if cfg.family == "rwkv":      # no attention; ln0 after the embedding
        return {"flash_attention_fwd": 0,
                "rmsnorm_fwd": (2 * cfg.n_layers + 2) * new_tokens,
                "moe_gemm_fwd": 0,
                "wkv6_fwd": cfg.n_layers * new_tokens, **no_backward}
    return {"flash_attention_fwd": cfg.n_layers,         # prefill only
            "rmsnorm_fwd": (2 * cfg.n_layers + 1) * new_tokens,
            "moe_gemm_fwd": 3 * n_moe * new_tokens,
            "wkv6_fwd": 0, **no_backward}


def serve(args, arch: str) -> dict:
    cfg = get_config(arch)
    model = build_model(cfg, max_cache_len=args.prompt_len + args.new_tokens)
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
    log(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}{moe}{rwkv}; weights {n_bytes / 1e9:.2f} GB made on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    loop = ServingLoop(model, params, args.batch, args.prompt_len,
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
        f"{args.prompt_len}); decode {decode_ms:.2f} ms/token step = "
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


def device_profile(what: str, step_ms: float, fn, top: int = 6) -> None:
    """Device time by kernel over one call of fn (torch.profiler), and the
    device's busy share of the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    log(f"{what} profile: device busy {busy:.2f} ms of {step_ms:.2f} ms "
        f"({100 * busy / step_ms:.1f}%, idle {100 - 100 * busy / step_ms:.1f}%)"
        f" in {sum(r[1] for r in rows)} kernel launches; {CARD}")
    ours = ("fa_fwd", "fa_bwd", "moe_gemm", "rms_", "wkv6_")
    for n, (ms, count, key) in enumerate(sorted(rows, reverse=True)):
        if n < top or any(k in key for k in ours):   # and the port's kernels
            log(f"  {ms:8.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  "
                f"x{count:<4d} {key[:90]}")


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


def kernel_vs_plain(args) -> None:
    cfg = get_config("llama3.1-8b").replace(n_layers=2)
    model = build_model(cfg, max_cache_len=args.prompt_len)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).long().cuda()
    with torch.inference_mode():
        lk, ck = model.prefill(params, {"tokens": tokens})
        with plain_path():
            lp, cp = model.prefill(params, {"tokens": tokens})
    V = cfg.vocab_size
    diff = (lk[..., :V].float() - lp[..., :V].float()).abs()
    cache_diff = max(max_err(a, b) for a, b in zip(ck["k"] + ck["v"],
                                                   cp["k"] + cp["v"]))
    log(f"2-layer full-width prefill, kernel vs plain path: logits max_abs "
        f"{float(diff.max()):.3e} mean_abs {float(diff.mean()):.3e} (tol "
        f"{E2E_TOL}), logit std {float(lp[..., :V].float().std()):.3f}; "
        f"KV cache max_abs {cache_diff:.3e}")
    if float(diff.max()) > E2E_TOL["max_abs"] or \
            float(diff.mean()) > E2E_TOL["mean_abs"]:
        raise AssertionError("kernel path and plain path disagree")


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
    """Launches of each kernel in ``steps`` dense training steps: every layer
    runs under an activation checkpoint, so its flash attention and norms
    run forward twice (the forward, the recompute in the backward) and
    backward once; the final norm once each way."""
    L = cfg.n_layers
    norms = 4 if cfg.qk_norm else 2                     # ln1, ln2 (q, k)
    return {"flash_attention_fwd": 2 * L * steps,
            "rmsnorm_fwd": (2 * norms * L + 1) * steps,
            "moe_gemm_fwd": 0, "wkv6_fwd": 0,
            "flash_attention_bwd": L * steps,
            "rmsnorm_bwd": (norms * L + 1) * steps}


class GradientCheck:
    """Trainer hook: every parameter leaf has a finite, non-zero gradient
    after each step, and each layer's slice of a stacked leaf too (a
    detached kernel output would leave the layers below it at zero)."""

    def __init__(self):
        self.step_times = []

    def __call__(self, step, metrics, trainer) -> None:
        torch.cuda.synchronize()
        self.step_times.append(time.perf_counter())
        bad = []
        for key, t in flatten_with_paths(trainer.state.params):
            g = t.grad
            if g is None:
                bad.append(f"{key}: no gradient")
                continue
            per = g.flatten(1).abs().amax(1) if key.startswith("g") \
                else g.abs().amax().reshape(1)
            if not bool(torch.isfinite(per).all()) or not bool((per > 0).all()):
                bad.append(f"{key}: zero or non-finite in slices "
                           f"{(~(per > 0)).nonzero().flatten().tolist()}")
        if bad:
            raise AssertionError(f"step {step}: " + "; ".join(bad))


def train(args) -> tuple:
    """Train full-width llama3.1-8b cut to TRAIN["layers"] layers through
    ``Trainer`` with the Lit Silicon hook; returns (launch counts, counts by
    path) of the trained steps."""
    cfg = get_config(TRAIN["arch"]).replace(n_layers=TRAIN["layers"])
    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoints"
    tc = TrainerConfig(
        model=cfg,
        train=TrainConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=steps,
                          checkpoint_every=0, checkpoint_dir=str(ck / "full"),
                          seed=args.seed),
        data=DataConfig(global_batch=B, seq_len=S, seed=args.seed))
    hook = LitSiliconHook(      # as launch/train.py: the FULL arch workload
        get_config(TRAIN["arch"]),
        ManagerConfig(use_case="gpu-red", sampling_period=2, warmup=3,
                      window_size=2), preset="mi300x")
    grads = GradientCheck()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(tc, hooks=[hook, grads], device="cuda")
    trainer.init_or_restore()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(trainer.state.params))
    log(f"train {cfg.name} cut to {cfg.n_layers} of 32 layers: d "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B fp32 "
        f"params + 2 fp32 moments made on the card in "
        f"{time.perf_counter() - t0:.1f} s; B {B} x S {S}, bf16 compute, "
        f"AdamW lr {TRAIN['lr']}, gpu-red hook")

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
    device_profile(f"{cfg.name} train step", step_ms,
                   lambda: trainer.run(1), top=10)
    del trainer, metrics
    torch.cuda.empty_cache()
    checkpoint_round_trip(ck / "reduced")
    return launches, by_path


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


def train_kernel_vs_plain(args, B: int = 2, S: int = 2048) -> None:
    """Loss and every gradient leaf of a 2-layer full-width llama3.1-8b cut,
    kernel path against plain path, on the same parameters and batch."""
    cfg = get_config(TRAIN["arch"]).replace(n_layers=2)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_train_params(gen, "cuda")
    data = SyntheticTokens(DataConfig(global_batch=B, seq_len=S,
                                      seed=args.seed), cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    results = []
    for plain in (False, True):
        for t in tree_leaves(params):
            t.grad = None
        with plain_path() if plain else nullcontext():
            loss, _ = model.loss(params, batch)
            loss.backward()
        results.append((float(loss.detach()),
                        [t.grad for t in tree_leaves(params)]))
    (lk, gk), (lp, gp) = results
    rows = []
    for (key, _), a, b in zip(flatten_with_paths(params), gk, gp):
        scale = float(b.abs().max())
        rows.append((key, float((a - b).abs().max()) / scale,
                     float((a - b).abs().mean()) / float(b.abs().mean())))
    worst_max = max(r[1] for r in rows)
    worst_mean = max(r[2] for r in rows)
    log(f"2-layer full-width training (B {B} x S {S}), kernel vs plain path: "
        f"loss {lk:.5f} vs {lp:.5f}; gradients, worst over "
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
# Phase 6: device times of the redesigned and the backward kernels
# --------------------------------------------------------------------------- #
def backward_device_times(g, rows: dict, rounds: int = 3) -> None:
    """Device time alone of the two backward kernels at their training
    shapes, of their plain versions and of the library's backward
    (autograd of F.scaled_dot_product_attention and of F.rms_norm), in
    ``rounds`` alternating rounds, their mean into the rows."""
    dev, bf = "cuda", torch.bfloat16
    q, do = (torch.randn(2, 4096, 32, 128, generator=g, device=dev).to(bf)
             for _ in range(2))
    k, v = (torch.randn(2, 4096, 8, 128, generator=g, device=dev).to(bf)
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    x, dy = (torch.randn(8192, 4096, generator=g, device=dev).to(bf)
             for _ in range(2))
    w = torch.randn(4096, generator=g, device=dev)
    fa, rms = rows["flash_attention_bwd"], rows["rmsnorm_bwd"]
    timed = [   # (row, key, fn, kernels a call)
        (fa, "device_ms", lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=True), 3),
        (fa, "plain_device_ms", lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=True), 0),
        (fa, "library_device_ms", sdpa_backward(q, k, v, do), 0),
        (rms, "device_ms", lambda: rmsnorm_bwd(x, w, dy), 2),
        (rms, "plain_device_ms", lambda: rmsnorm_bwd_ref(x, w, dy), 0),
        (rms, "library_device_ms", rms_norm_backward(x, w, dy), 0),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--host-only", action="store_true",
                    help="phase 1 and the host cost per call only")
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
    rows = [flash_checks(g), rmsnorm_checks(g), moe_gemm_checks(g),
            wkv6_checks(g), flash_bwd_checks(g), rmsnorm_bwd_checks(g)]
    costs = host_costs(g)
    for row in rows:
        row.update(costs.get(row["name"], {}))
    torch.cuda.empty_cache()
    by_run = {"llama3.1-8b": serve(args, "llama3.1-8b")}
    kernel_vs_plain(args)
    by_run["deepseek-v3-16b"] = serve(args, "deepseek-v3-16b")
    moe_kernel_vs_plain(args)
    by_run["rwkv6-3b"] = serve(args, "rwkv6-3b")
    rwkv_kernel_vs_plain(args)
    torch.cuda.empty_cache()
    by_run["llama3.1-8b train"] = train(args)
    train_kernel_vs_plain(args)
    by_name = {row["name"]: row for row in rows}
    device_times(g, by_name)
    backward_device_times(g, by_name)
    for row, fn in zip(rows, KERNELS):
        name = fn.__name__
        counts = {arch: n[name] for arch, (n, _) in by_run.items()}
        row["launches"] = sum(counts.values())
        row["launches_by_run"] = counts
        if hasattr(fn, "launches_by_path"):
            row["launches_by_path"] = {
                path: sum(p[name][path] for _, p in by_run.values())
                for path in fn.launches_by_path}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
