"""Kernel modules of the PyTorch port against the JAX package's kernels.

Each plain version (the CPU path of the port's kernel wrappers) is held
against the JAX oracle and the Pallas kernel (interpret mode) on the same
numpy inputs (the CUDA kernels are held against the plain versions on a
card in tests/test_torch_cuda.py, which imports no JAX).  Tolerances are the JAX package's
own (tests/test_kernels.py): fp32 2e-5, bf16 2e-2; the grouped GEMM's atol
grows with the contraction depth as sqrt(d).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention as pallas_fa,
                                           flash_attention_ref as jax_fa_ref)
from repro.kernels.moe_gemm import moe_gemm as pallas_moe_gemm
from repro.kernels.moe_gemm import moe_gemm_ref as jax_moe_gemm_ref
from repro.kernels.rmsnorm import rmsnorm as pallas_rms
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rms_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_fwd
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _mask(S, seed=3):
    m = np.random.default_rng(seed).random((S, S)) < 0.7
    np.fill_diagonal(m, True)
    return m


def _bh(x):
    """(B, S, H, D) -> (B*H, S, D), the layout of the JAX oracle."""
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


# ------------------------------------------------------------ flash attention
CASES = {
    "causal": dict(causal=True),
    "window32": dict(causal=True, window=32),
    "noncausal": dict(causal=False),
    "mask": dict(causal=False, mask=True),
}


@pytest.mark.parametrize("S", [64, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_plain_matches_jax(case, dtype, S):
    """GQA 4/2 heads, ragged S=200 included: the port's plain version
    against the jnp oracle and the Pallas kernel."""
    kw = CASES[case]
    B, H, kvH, D = 2, 4, 2, 32
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, kvH, kvH))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    mask = _mask(S) if kw.get("mask") else None
    out = flash_attention(tq, tk, tv,
                          None if mask is None else torch.from_numpy(mask),
                          causal=kw["causal"], window=kw.get("window", 0))
    assert out.dtype == tq.dtype and out.shape == (B, S, H, D)

    jkk, jvv = (jnp.repeat(t, H // kvH, axis=2) for t in (jk, jv))
    ref = jax_fa_ref(_bh(jq), _bh(jkk), _bh(jvv), causal=kw["causal"],
                     window=kw.get("window", 0),
                     mask=None if mask is None else jnp.asarray(mask))
    ref = np.asarray(ref, np.float32).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), ref, atol=tol, rtol=tol)
    if case == "noncausal" and S % 8:
        return      # the Pallas kernel's ragged non-causal path drops window
    pal = pallas_fa(jq, jk, jv,
                    mask=None if mask is None else jnp.asarray(mask),
                    causal=kw["causal"], window=kw.get("window", 0))
    np.testing.assert_allclose(_np(out), _np(pal), atol=tol, rtol=tol)


def test_flash_plain_q_offset_matches_oracle_suffix():
    """q_offset shifts the causal diagonal: the last rows of a full causal
    run equal a run of just those queries at their offset."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 40, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    full = flash_attention_ref(q, k, v, causal=True, window=8, chunk=16)
    tail = flash_attention_ref(q[:, 30:], k, v, causal=True, window=8,
                               q_offset=30, chunk=16)
    np.testing.assert_allclose(tail.numpy(), full[:, 30:].numpy(), atol=2e-6)


def test_flash_kernel_wrapper_rejects_cpu_tensors():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q, causal=True)


# ------------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape", [(4, 128), (2, 100, 256), (1, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(2)
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    (jx, tx), (jr, tr) = _pair(x, dtype), _pair(r, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    tol = DTYPES[dtype][2]
    y = rmsnorm(tx, tw)
    assert y.dtype == tx.dtype
    for ref in (jax_rms_ref(jx, jw), pallas_rms(jx, jw)):
        np.testing.assert_allclose(_np(y), _np(ref), atol=tol)
    y2, res2 = rmsnorm(tx, tw, tr)
    for o, res in (jax_rms_ref(jx, jw, jr), pallas_rms(jx, jw, jr)):
        np.testing.assert_allclose(_np(y2), _np(o), atol=tol)
        np.testing.assert_allclose(_np(res2), _np(res), atol=tol)


def test_rmsnorm_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_fwd(torch.zeros(2, 64), torch.ones(64))


# ------------------------------------------------------------------ moe gemm
@pytest.mark.parametrize("ECdh", [(4, 64, 96, 200), (2, 100, 48, 64),
                                  (8, 8, 16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_plain_matches_jax(dtype, ECdh):
    """The JAX sweep's shapes: the port's plain version against the jnp
    oracle and the Pallas kernel."""
    E, C, d, h = ECdh
    rng = np.random.default_rng(6)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, h)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    out = moe_gemm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (E, C, h)
    tol = DTYPES[dtype][2]
    for ref in (jax_moe_gemm_ref(jx, jw), pallas_moe_gemm(jx, jw)):
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol * np.sqrt(d),
                                   rtol=tol)


def test_moe_gemm_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm_fwd(torch.zeros(2, 8, 16), torch.zeros(2, 16, 4))
