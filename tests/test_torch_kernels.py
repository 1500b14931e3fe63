"""Kernel modules of the PyTorch port against the JAX package's kernels.

Each plain version (the CPU path of the port's kernel wrappers) is held
against the JAX oracle and the Pallas kernel (interpret mode) on the same
numpy inputs (the CUDA kernels are held against the plain versions on a
card in tests/test_torch_cuda.py, which imports no JAX).  Tolerances are the JAX package's
own (tests/test_kernels.py): fp32 2e-5, bf16 2e-2; the grouped GEMM's atol
grows with the contraction depth as sqrt(d).
"""
import ctypes
import re

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
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd,
                                                        flash_bwd_path,
                                                        flash_path)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.moe_gemm import kernel as moe_kernel
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_fwd, moe_gemm_path
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_bwd, rmsnorm_fwd,
                                                rmsnorm_path)
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_fwd, wkv6_path

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


def _offset(shape, dtype, elems):
    """A tensor of ``shape`` whose storage starts ``elems`` elements in."""
    n = int(np.prod(shape))
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


def _fused_qkv(B, S, H, kvH, D, dtype=torch.bfloat16, pad=0):
    """q, k, v as views of one (B, S, (H + 2 kvH) D + pad) projection."""
    f = torch.zeros(B, S, (H + 2 * kvH) * D + pad, dtype=dtype)
    q = f[..., :H * D].view(B, S, H, D)
    k = f[..., H * D:(H + kvH) * D].view(B, S, kvH, D)
    v = f[..., (H + kvH) * D:(H + 2 * kvH) * D].view(B, S, kvH, D)
    return q, k, v


BF = torch.bfloat16
FLASH_PATHS = {   # name: (q, k, v), the kernel that takes them
    "bf16 D128": (lambda: [torch.zeros(2, 64, h, 128, dtype=BF)
                           for h in (8, 2, 2)], "wgmma"),
    "bf16 D64": (lambda: [torch.zeros(2, 64, h, 64, dtype=BF)
                          for h in (4, 4, 4)], "wgmma"),
    "bf16 D32": (lambda: [torch.zeros(2, 64, 4, 32, dtype=BF)] * 3, "simt"),
    "bf16 D16": (lambda: [torch.zeros(2, 64, 4, 16, dtype=BF)] * 3, "simt"),
    "fp32 D128": (lambda: [torch.zeros(2, 64, 4, 128)] * 3, "simt"),
    "fp32 D128 unaligned": (lambda: [_offset((2, 64, 4, 128),
                                             torch.float32, 1)] * 3, "simt"),
    "bf16 fused qkv view": (lambda: _fused_qkv(2, 64, 8, 2, 128), "wgmma"),
    "bf16 one token, one batch": (lambda: [torch.zeros(1, 1, 4, 64,
                                                       dtype=BF)] * 3,
                                  "wgmma"),
    "bf16 transposed heads": (lambda: [torch.zeros(2, 4, 64, 128, dtype=BF)
                                       .transpose(1, 2)] * 3, "wgmma"),
    "bf16 unaligned base": (lambda: [_offset((2, 64, 4, 128), BF, 4)] * 3,
                            ValueError),
    "bf16 q unaligned, k v aligned": (
        lambda: [_offset((2, 64, 4, 64), BF, 1)]
        + [torch.zeros(2, 64, 4, 64, dtype=BF)] * 2, ValueError),
    "bf16 seq stride of 8 bytes past 16": (
        lambda: _fused_qkv(2, 64, 4, 2, 64, pad=4), ValueError),
    "bf16 D not unit-stride": (lambda: [torch.zeros(2, 64, 128, 4, dtype=BF)
                                        .transpose(2, 3)] * 3, ValueError),
}


@pytest.mark.parametrize("case", list(FLASH_PATHS))
def test_flash_path_by_dtype_head_size_and_layout(case):
    """bf16 with D 64 or 128 goes to the wgmma kernel, which TMA feeds (a
    16-byte aligned base, strides of whole 16 bytes, unit stride on D; a
    size-1 dim's stride is never read); the rest to the CUDA-core kernel;
    bf16 inputs TMA cannot read raise instead of going elsewhere."""
    make, want = FLASH_PATHS[case]
    q, k, v = make()
    if want is ValueError:
        with pytest.raises(ValueError, match="cannot be read by TMA"):
            flash_path(q, k, v)
    else:
        assert flash_path(q, k, v) == want


FLASH_BWD_PATHS = {   # name: (q, k, v, do), the kernels that take them
    "bf16 D128": (lambda: [torch.zeros(2, 64, h, 128, dtype=BF)
                           for h in (8, 2, 2, 8)], "wgmma"),
    "bf16 D64 G 1": (lambda: [torch.zeros(2, 65, 4, 64, dtype=BF)] * 4,
                     "wgmma"),
    "bf16 one token": (lambda: [torch.zeros(1, 1, 4, 64, dtype=BF)] * 4,
                       "wgmma"),
    "bf16 D32": (lambda: [torch.zeros(2, 64, 4, 32, dtype=BF)] * 4, "simt"),
    "bf16 D16": (lambda: [torch.zeros(2, 64, 4, 16, dtype=BF)] * 4, "simt"),
    "fp32 D128": (lambda: [torch.zeros(2, 64, 4, 128)] * 4, "simt"),
    "fp32 D64 unaligned": (lambda: [_offset((2, 64, 4, 64),
                                            torch.float32, 1)] * 4, "simt"),
    "bf16 q unaligned": (lambda: [_offset((2, 64, 4, 128), BF, 4)]
                         + [torch.zeros(2, 64, 4, 128, dtype=BF)] * 3,
                         ValueError),
    "bf16 do unaligned": (lambda: [torch.zeros(2, 64, 4, 64, dtype=BF)] * 3
                          + [_offset((2, 64, 4, 64), BF, 1)], ValueError),
    "bf16 seq stride of 8 bytes past 16": (
        lambda: list(_fused_qkv(2, 64, 4, 2, 64, pad=4))
        + [torch.zeros(2, 64, 4, 64, dtype=BF)], ValueError),
}


@pytest.mark.parametrize("case", list(FLASH_BWD_PATHS))
def test_flash_backward_path_by_dtype_head_size_and_layout(case):
    """The backward follows the forward's rule: bf16 with D 64 or 128 goes
    to the wgmma kernels, which TMA feeds (q, k, v and dO), fp32 and D 16/32
    to the CUDA-core kernels; bf16 inputs TMA cannot read raise instead of
    going elsewhere."""
    make, want = FLASH_BWD_PATHS[case]
    q, k, v, do = make()
    if want is ValueError:
        with pytest.raises(ValueError, match="cannot be read by TMA"):
            flash_bwd_path(q, k, v, do)
    else:
        assert flash_bwd_path(q, k, v, do) == want


MOE_PATHS = {     # name: (x, w), the kernel that takes them
    "bf16 aligned": (lambda: (torch.zeros(4, 8, 64, dtype=BF),
                              torch.zeros(4, 64, 24, dtype=BF)), "wgmma"),
    "bf16 prefill capacity": (lambda: (torch.zeros(2, 240, 72, dtype=BF),
                                       torch.zeros(2, 72, 136, dtype=BF)),
                              "wgmma"),
    "bf16 d not a multiple of 8": (lambda: (torch.zeros(2, 8, 100, dtype=BF),
                                            torch.zeros(2, 100, 64,
                                                        dtype=BF)), "wmma"),
    "bf16 h not a multiple of 8": (lambda: (torch.zeros(2, 8, 64, dtype=BF),
                                            torch.zeros(2, 64, 45,
                                                        dtype=BF)), "wmma"),
    "bf16 d = 0": (lambda: (torch.zeros(2, 8, 0, dtype=BF),
                            torch.zeros(2, 0, 64, dtype=BF)), "wmma"),
    "bf16 x unaligned": (lambda: (_offset((2, 8, 64), BF, 4),
                                  torch.zeros(2, 64, 64, dtype=BF)), "wmma"),
    "bf16 w unaligned": (lambda: (torch.zeros(2, 8, 64, dtype=BF),
                                  _offset((2, 64, 64), BF, 2)), "wmma"),
    "fp32": (lambda: (torch.zeros(2, 8, 64), torch.zeros(2, 64, 64)), "simt"),
}


@pytest.mark.parametrize("case", list(MOE_PATHS))
def test_moe_gemm_path_by_dtype_shape_and_alignment(case):
    """Aligned bf16 with d and h multiples of 8 goes to the wgmma kernel
    (TMA's rules), other bf16 to the element-wise wmma kernel, fp32 to the
    CUDA-core kernel."""
    make, want = MOE_PATHS[case]
    assert moe_gemm_path(*make()) == want


def test_path_codes_match_the_c_enum():
    """_build.PATHS[i] is the kernel that code i asks the entry points for
    (enum Path of csrc/common.cuh)."""
    src = (_build.CSRC / "common.cuh").read_text()
    enum = re.search(r"enum Path : int \{([^}]*)\}", src).group(1)
    codes = {name.strip()[len("kPath"):].lower(): int(code)
             for name, code in re.findall(r"(\w+)\s*=\s*(\d+)", enum)}
    assert codes == {name: i for i, name in enumerate(_build.PATHS)}


@pytest.mark.parametrize("source,entry,module", [
    ("flash_attention.cu", "flash_attention_fwd", flash_kernel),
    ("moe_gemm.cu", "moe_gemm_fwd", moe_kernel),
    ("rmsnorm.cu", "rmsnorm_fwd", rms_kernel),
    ("wkv6.cu", "wkv6_fwd", wkv_kernel),
    ("flash_attention_bwd.cu", "flash_attention_bwd", flash_kernel)])
def test_entry_point_takes_the_chosen_path_by_value(source, entry, module):
    """The C entry point's last parameter is the path the wrapper chose, an
    int passed by value, and the ctypes binding says so."""
    src = (_build.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    assert params.split(",")[-1].split() == ["int", "path"]
    bound = module._BWD_ARGTYPES if entry.endswith("_bwd") \
        else module._ARGTYPES
    assert bound[-1] is ctypes.c_int
    assert len(bound) == len(params.split(","))


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


@pytest.mark.parametrize("source,entry,module", [
    ("flash_attention_bwd.cu", "flash_attention_bwd", flash_kernel),
    ("rmsnorm.cu", "rmsnorm_bwd", rms_kernel)])
def test_backward_entry_points_bind_every_parameter(source, entry, module):
    """The ctypes binding of each backward entry point has one type per C
    parameter, c_void_p for every pointer (stream included): a pointer
    bound as an int would be cut to 32 bits."""
    src = (_build.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    ctypes_of = [_C_TYPES[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert module._BWD_ARGTYPES == ctypes_of


@pytest.mark.parametrize("fn", [flash_attention_bwd, rmsnorm_bwd])
def test_backward_wrappers_count_once_a_call_and_reject_cpu(fn):
    """The flash backward counts its wgmma and simt kernels apart, RMSNorm's
    its one path; a CPU tensor is refused before anything is counted."""
    paths = {"wgmma", "simt"} if fn is flash_attention_bwd else {"simt"}
    assert set(fn.launches_by_path) == paths and fn.launches == 0
    assert set(fn.launches_by_path) <= set(_build.PATHS)
    x = torch.zeros(1, 8, 2, 16)
    if fn is flash_attention_bwd:
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, x, x, x, torch.zeros(1, 2, 8), x, causal=True)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, torch.ones(16), x)
    assert fn.launches == 0


@pytest.mark.parametrize("fn,fast", [(flash_attention_fwd, "wgmma"),
                                     (moe_gemm_fwd, "wgmma"),
                                     (rmsnorm_fwd, "vector"),
                                     (wkv6_fwd, "split")])
def test_count_launch_counts_the_path_and_reset_clears(fn, fast):
    """Each wrapper counts its launches by path: its Hopper kernel and the
    CUDA-core kernel kept beside it, every path a code of _build.PATHS."""
    assert set(fn.launches_by_path) == {fast, "simt"} | (
        {"wmma"} if fn is moe_gemm_fwd else set())
    assert set(fn.launches_by_path) <= set(_build.PATHS)
    saved = fn.launches, dict(fn.launches_by_path)
    try:
        _build.reset_counts(fn)
        for path in (fast, fast, "simt"):
            _build.count_launch(fn, path)
        assert fn.launches == 3
        assert fn.launches_by_path[fast] == 2
        assert fn.launches_by_path["simt"] == 1
        _build.reset_counts(fn)
        assert fn.launches == 0 and not any(fn.launches_by_path.values())
    finally:
        fn.launches, fn.launches_by_path = saved[0], saved[1]


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


RMS_PATHS = {     # name: (x, w, residual), the kernel that takes them
    "bf16 d 4096, fp32 w": (lambda: (torch.zeros(4, 4096, dtype=BF),
                                     torch.zeros(4096), None), "vector"),
    "bf16 d 4096, residual": (lambda: (torch.zeros(4, 4096, dtype=BF),
                                       torch.zeros(4096, dtype=BF),
                                       torch.zeros(4, 4096, dtype=BF)),
                              "vector"),
    "bf16 qk-norm d 128 (a warp a row)": (
        lambda: (torch.zeros(64, 128, dtype=BF), torch.zeros(128), None),
        "simt"),
    "bf16 d 1024 (a warp a row)": (lambda: (torch.zeros(4, 1024, dtype=BF),
                                            torch.zeros(1024), None), "simt"),
    "bf16 d 1032": (lambda: (torch.zeros(4, 1032, dtype=BF),
                             torch.zeros(1032), None), "vector"),
    "fp32 d 2560": (lambda: (torch.zeros(3, 2560), torch.zeros(2560), None),
                    "vector"),
    "fp32 d 2052, bf16 w": (lambda: (torch.zeros(3, 2052),
                                     torch.zeros(2052, dtype=BF), None),
                            "vector"),
    "bf16 d 16384 (32 KB rows)": (lambda: (torch.zeros(1, 16384, dtype=BF),
                                           torch.zeros(16384), None),
                                  "vector"),
    "fp32 d 8196 (over 32 KB)": (lambda: (torch.zeros(1, 8196),
                                          torch.zeros(8196), None), "simt"),
    "bf16 d 1500 (3000-byte rows)": (lambda: (torch.zeros(4, 1500, dtype=BF),
                                              torch.zeros(1500), None),
                                     "simt"),
    "fp32 d 1002": (lambda: (torch.zeros(4, 1002), torch.zeros(1002), None),
                    "simt"),
    "bf16 x unaligned": (lambda: (_offset((4, 4096), BF, 1), torch.zeros(4096),
                                  None), "simt"),
    "bf16 x 8 bytes off": (lambda: (_offset((4, 4096), BF, 4),
                                    torch.zeros(4096), None), "simt"),
    "w unaligned": (lambda: (torch.zeros(4, 2048, dtype=BF),
                             _offset((2048,), torch.float32, 1), None),
                    "simt"),
    "residual unaligned": (lambda: (torch.zeros(4, 2048, dtype=BF),
                                    torch.zeros(2048),
                                    _offset((4, 2048), BF, 2)), "simt"),
}


@pytest.mark.parametrize("case", list(RMS_PATHS))
def test_rmsnorm_path_by_width_and_alignment(case):
    """Rows wider than 1024 of whole 16-byte words, at most 32 KB, on 16-byte
    aligned bases of x, w and the residual go to the vector kernel; the rest,
    narrow rows among them, to the scalar kernel."""
    make, want = RMS_PATHS[case]
    assert rmsnorm_path(*make()) == want


WKV_PATHS = {     # name: (r, k, v, w_log, state), the kernel that takes them
    "bf16, no state": (lambda: [torch.zeros(2, 5, 3, 64, dtype=BF)] * 3
                       + [torch.zeros(2, 5, 3, 64), None], "split"),
    "fp32, state": (lambda: [torch.zeros(2, 5, 3, 32)] * 4
                    + [torch.zeros(2, 3, 32, 32)], "split"),
    "one token, D 16": (lambda: [torch.zeros(1, 1, 4, 16, dtype=BF)] * 3
                        + [torch.zeros(1, 1, 4, 16),
                           torch.zeros(1, 4, 16, 16)], "split"),
    "r unaligned": (lambda: [_offset((2, 5, 3, 64), BF, 1)]
                    + [torch.zeros(2, 5, 3, 64, dtype=BF)] * 2
                    + [torch.zeros(2, 5, 3, 64), None], "simt"),
    "w_log unaligned": (lambda: [torch.zeros(2, 5, 3, 64, dtype=BF)] * 3
                        + [_offset((2, 5, 3, 64), torch.float32, 2), None],
                        "simt"),
    "state unaligned": (lambda: [torch.zeros(2, 5, 3, 64)] * 4
                        + [_offset((2, 3, 64, 64), torch.float32, 1)],
                        "simt"),
}


@pytest.mark.parametrize("case", list(WKV_PATHS))
def test_wkv6_path_by_alignment(case):
    """Inputs whose bases TMA and the 16-byte loads can read go to the
    split kernel; any base off the 16-byte grid to the one-column-a-thread
    kernel."""
    make, want = WKV_PATHS[case]
    r, k, v, w, state = make()
    assert wkv6_path(r, k, v, w, state) == want


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
