"""Chip smoke test of the PyTorch port on one NVIDIA card.

  python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. the card (nvidia-smi) and the build of every CUDA kernel from csrc/;
2. each kernel against its plain PyTorch version on the card, at the shapes
   serving gives it and at small edge cases, with the kernel's, the plain
   version's and one library call's time (CUDA events, L2 flushed);
3. full-width, full-depth llama3.1-8b (random bf16 weights from --seed)
   served through ``ServingLoop``: batch 4, prompt 512, 32 greedy tokens,
   with every kernel's launch count read over that run alone, then timed
   (host clock) and profiled (device time by kernel, busy share);
4. the kernel path against the plain path on the same prefill at full
   width, cut to 2 layers;
5. the JSON line of the kernels, then the JSON line of the device.

It needs ``src/repro_torch`` beside it, and CUDA; without either it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.decode import ServeConfig, ServingLoop  # noqa: E402

# H100 SXM data sheet (dense, 700 W): the card's least time for a function
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# kernel path vs plain path, 2-layer full-width bf16 prefill logits: the two
# paths round to bf16 at the same points but sum in another order, so values
# on a rounding boundary move one bf16 step (2**-8 relative), and such flips
# compound through 2 layers; the logits are of unit scale
E2E_TOL = {"max_abs": 0.25, "mean_abs": 0.02}
KERNELS = [fa_ops.flash_attention_fwd, rms_ops.rmsnorm_fwd]


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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


# --------------------------------------------------------------------------- #
# Phase 1: card and build
# --------------------------------------------------------------------------- #
def card() -> None:
    for query in ("name,power.limit",
                  "name,power.limit,clocks.sm,temperature.gpu,power.draw"):
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        log(out.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    for name in ("flash_attention", "rmsnorm"):
        _build.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    for entry in _build.build_log:
        for line in entry.splitlines():
            if line.startswith("==") or "Used" in line or "spill" in line:
                log("  " + line.strip())


# --------------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def flash_checks(g) -> dict:
    dev = "cuda"
    log("flash attention (kernel vs plain):")
    cases = [  # (B, S, H, kvH, D, dtype, causal, window, mask)
        (4, 200, 8, 2, 64, torch.float32, True, 0, False),
        (2, 200, 8, 2, 64, torch.bfloat16, True, 32, False),
        (2, 131, 4, 4, 128, torch.float32, False, 0, False),
        (2, 96, 4, 2, 32, torch.bfloat16, False, 0, True),
        (1, 77, 4, 1, 16, torch.float32, True, 16, True),
    ]
    for B, S, H, kvH, D, dt, causal, window, use_mask in cases:
        q = torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
        mask = None
        if use_mask:
            mask = torch.rand(S, S, generator=g, device=dev) < 0.6
            mask |= torch.eye(S, dtype=torch.bool, device=dev)
        kw = dict(causal=causal, window=window)
        err = max_err(flash_attention_fwd(q, k, v, mask, **kw),
                      flash_attention_ref(q, k, v, mask, **kw))
        check(f"B{B} S{S} H{H}/{kvH} D{D} {str(dt)[6:]} causal={causal} "
              f"window={window} mask={use_mask}", err, TOL[dt])

    # the serving prefill shape: B 4, S 512, H 32/8, D 128, bf16, causal
    B, S, H, kvH, D, dt = 4, 512, 32, 8, 128, torch.bfloat16
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, kvH, D, generator=g, device=dev).to(dt)
    err = max_err(flash_attention_fwd(q, k, v, causal=True),
                  flash_attention_ref(q, k, v, causal=True))
    check(f"main shape B{B} S{S} H{H}/{kvH} D{D} bf16 causal", err, TOL[dt])
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
    log(f"  main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
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
                bound_by=b_by, library_ms=lib_ms)


def rmsnorm_checks(g) -> dict:
    dev = "cuda"
    log("rmsnorm (kernel vs plain):")
    cases = [  # (rows, d, x dtype, w dtype, residual)
        (4, 4096, torch.bfloat16, torch.float32, False),      # decode
        (2048, 4096, torch.bfloat16, torch.float32, True),    # residual form
        (4096, 128, torch.bfloat16, torch.float32, False),    # qk-norm width
        (37, 2560, torch.float32, torch.float32, True),
        (9, 1000, torch.float32, torch.bfloat16, False),
    ]
    for rows, d, dt, wdt, res in cases:
        x = torch.randn(rows, d, generator=g, device=dev).to(dt)
        w = torch.randn(d, generator=g, device=dev).to(wdt)
        if res:
            r = torch.randn(rows, d, generator=g, device=dev).to(dt)
            y, s = rmsnorm_fwd(x, w, r)
            y_ref, s_ref = rmsnorm_ref(x, w, r)
            err = max(max_err(y, y_ref), max_err(s, s_ref))
        else:
            err = max_err(rmsnorm_fwd(x, w), rmsnorm_ref(x, w))
        check(f"rows {rows} d {d} x {str(dt)[6:]} w {str(wdt)[6:]} "
              f"residual={res}", err, TOL[dt])

    # the serving prefill shape: 2048 rows of 4096, bf16, fp32 weight
    x = torch.randn(2048, 4096, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(4096, generator=g, device=dev)
    err = max_err(rmsnorm_fwd(x, w), rmsnorm_ref(x, w))
    check("main shape 2048x4096 bf16", err, TOL[torch.bfloat16])
    ms = cuda_ms(lambda: rmsnorm_fwd(x, w))
    plain_ms = cuda_ms(lambda: rmsnorm_ref(x, w))
    lib_ms = cuda_ms(lambda: F.rms_norm(x, (4096,), w.to(x.dtype), 1e-5))
    xd = x[:4].clone()
    dec_ms = cuda_ms(lambda: rmsnorm_fwd(xd, w))
    nbytes = 2 * x.numel() * 2 + w.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * x.numel(), torch.bfloat16)
    log(f"  main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.rms_norm {lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB); decode shape 4x4096: kernel {dec_ms:.4f} ms")
    # the residual form (the TPU's _rms_res_kernel) at the same shape
    r = torch.randn(2048, 4096, generator=g, device=dev).to(torch.bfloat16)
    r_ms = cuda_ms(lambda: rmsnorm_fwd(x, w, r))
    r_plain = cuda_ms(lambda: rmsnorm_ref(x, w, r))
    r_bound, r_by = bound(4 * x.numel() * 2 + w.numel() * 4, 5 * x.numel(),
                          torch.bfloat16)
    log(f"  residual form: kernel {r_ms:.4f} ms, plain {r_plain:.4f} ms, "
        f"bound {r_bound * 1e3:.2f} us ({r_by})")
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm/kernel.py:34",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# --------------------------------------------------------------------------- #
# Phase 3: serve llama3.1-8b
# --------------------------------------------------------------------------- #
def serve(args) -> tuple:
    cfg = get_config("llama3.1-8b")
    model = build_model(cfg, max_cache_len=args.prompt_len + args.new_tokens)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init_params(gen, "cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"llama3.1-8b: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; weights {n_bytes / 1e9:.2f} GB made on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    loop = ServingLoop(model, params, args.batch, args.prompt_len,
                       ServeConfig(max_new_tokens=args.new_tokens),
                       device="cuda")

    log(f"launch counts before the run: "
        f"{ {k.__name__: k.launches for k in KERNELS} }; set to 0")
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = loop.serve(prompts)                       # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    log(f"served {out.shape} tokens in {wall:.3f} s; launch counts after "
        f"the run: {launches}")

    if out.shape != (args.batch, args.new_tokens) or out.min() < 0 \
            or out.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    per_forward = {"flash_attention_fwd": cfg.n_layers,
                   "rmsnorm_fwd": 2 * cfg.n_layers + 1}
    for name, n in per_forward.items():
        want = n if name == "flash_attention_fwd" else n * args.new_tokens
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {want}")

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
    log(f"prefill {prefill_ms:.2f} ms (B {args.batch} x S {args.prompt_len}); "
        f"decode {decode_ms:.2f} ms/token step = "
        f"{args.batch * 1e3 / decode_ms:.1f} tokens/s; served "
        f"{args.batch * args.new_tokens / wall:.1f} tokens/s end to end; "
        f"peak memory {peak:.2f} GB")
    with torch.inference_mode():
        device_profile("prefill", prefill_ms,
                       lambda: model.prefill(params, {"tokens": tokens}))
        device_profile("decode step", decode_ms,
                       lambda: model.decode_step(params, tok, cache))
    del params, cache, loop
    torch.cuda.empty_cache()
    return launches


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
        f"({100 * busy / step_ms:.1f}%, idle {100 - 100 * busy / step_ms:.1f}%)")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {ms:8.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  x{count:<4d} "
            f"{key[:90]}")


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
    """Route the ops of a CUDA run through the plain versions."""
    with mock.patch.object(fa_ops, "flash_attention_fwd",
                           flash_attention_ref), \
            mock.patch.object(rms_ops, "rmsnorm_fwd", rmsnorm_ref):
        yield


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card()
    build()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = [flash_checks(g), rmsnorm_checks(g)]
    launches = serve(args)
    kernel_vs_plain(args)
    for row, fn in zip(rows, KERNELS):
        row["launches"] = launches[fn.__name__]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
