"""ctypes wrappers of the CUDA grouped expert GEMM (``csrc/moe_gemm.cu``)
and of its two transposed forms for the backward (``csrc/moe_gemm_bwd.cu``).

``moe_gemm_fwd`` replaces the TPU kernel
``repro/kernels/moe_gemm/kernel.py:moe_gemm_fwd``; ``moe_gemm_dgrad`` and
``moe_gemm_wgrad`` take the place of XLA's autodiff of the expert einsums
(``repro/models/moe.py:91-93``).  Each wrapper's ``launches`` counts its
launches, and ``launches_by_path`` counts them by kernel: ``"wgmma"`` (bf16
that TMA can read: tensor cores), ``"wmma"`` (the forward's bf16 that it
cannot: d or h not a multiple of 8, or an unaligned base) and ``"simt"``
(fp32, and the backward's bf16 that TMA cannot read: CUDA cores).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I]


def _tma_reads(d: int, h: int, *tensors: torch.Tensor) -> bool:
    """TMA can read (E, ., d) and (E, ., h) bf16 tensors: d > 0, d and h
    multiples of 8 (16-byte rows), 16-byte aligned bases."""
    return d > 0 and d % 8 == 0 and h % 8 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in tensors)


def moe_gemm_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel that takes x (E, C, d), w (E, d, h): ``"simt"`` for fp32;
    for bf16 ``"wgmma"`` where TMA can read both (d > 0, d and h multiples of
    8, 16-byte aligned bases), else ``"wmma"``."""
    if x.dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if _tma_reads(x.shape[2], w.shape[2], x, w) else "wmma"


def moe_gemm_bwd_path(a: torch.Tensor, b: torch.Tensor, d: int,
                      h: int) -> str:
    """The backward kernel that takes operands a and b of either form
    (dgrad: dy (E, C, h), w (E, d, h); wgrad: x (E, C, d), dy (E, C, h)):
    ``"wgmma"`` for bf16 that TMA can read, else ``"simt"``."""
    if a.dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if _tma_reads(d, h, a, b) else "simt"


def _check(what: str, tensors, shapes_ok: bool, want: str) -> None:
    if not shapes_ok:
        raise ValueError(f"{what}: expected {want}; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    dev = tensors[0].device
    if not dev.type == "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs CUDA tensors on one device; "
                         f"got {[str(t.device) for t in tensors]}")
    dt = tensors[0].dtype
    if dt not in _build.DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what} kernel takes float32 or bfloat16 for every "
                        f"operand; got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous operands")


def moe_gemm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, h) contiguous CUDA tensors of one dtype
    (float32 or bfloat16) -> (E, C, h) in that dtype."""
    _check("moe_gemm", (x, w), x.dim() == 3 and w.dim() == 3
           and w.shape[0] == x.shape[0] and w.shape[1] == x.shape[2],
           "x (E, C, d) and w (E, d, h)")
    E, C, d = x.shape
    h = w.shape[2]
    y = torch.empty((E, C, h), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    path = moe_gemm_path(x, w)
    fn = _build.entry("moe_gemm", "moe_gemm_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
             _build.DTYPE_CODES[x.dtype], E, C, d, h,
             torch.cuda.current_stream(x.device).cuda_stream,
             _build.PATHS.index(path))
    _build.check("moe_gemm", err, "moe_gemm_fwd")
    _build.count_launch(moe_gemm_fwd, path)
    return y


moe_gemm_fwd.launches = 0
moe_gemm_fwd.launches_by_path = {"wgmma": 0, "wmma": 0, "simt": 0}


def moe_gemm_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx (E, C, d) = dy (E, C, h) w^T for w (E, d, h): contiguous CUDA
    tensors of one dtype, fp32 accumulation, dx in that dtype."""
    _check("moe_gemm_dgrad", (dy, w), dy.dim() == 3 and w.dim() == 3
           and w.shape[0] == dy.shape[0] and w.shape[2] == dy.shape[2],
           "dy (E, C, h) and w (E, d, h)")
    E, C, h = dy.shape
    d = w.shape[1]
    dx = torch.empty((E, C, d), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    if h == 0:
        return dx.zero_()
    return _launch_bwd("moe_gemm_dgrad", moe_gemm_dgrad, dy, w, dx, E, C, d, h)


def moe_gemm_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw (E, d, h) = x^T dy, contracted over C, for x (E, C, d), dy (E, C,
    h): contiguous CUDA tensors of one dtype, fp32 accumulation, dw in that
    dtype (the weight's: x and w share it)."""
    _check("moe_gemm_wgrad", (x, dy), x.dim() == 3 and dy.dim() == 3
           and dy.shape[:2] == x.shape[:2], "x (E, C, d) and dy (E, C, h)")
    E, C, d = x.shape
    h = dy.shape[2]
    dw = torch.empty((E, d, h), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    if C == 0:
        return dw.zero_()
    return _launch_bwd("moe_gemm_wgrad", moe_gemm_wgrad, x, dy, dw, E, C, d, h)


def _launch_bwd(name, fn, a, b, out, E, C, d, h):
    path = moe_gemm_bwd_path(a, b, d, h)
    entry = _build.entry("moe_gemm_bwd", name, _ARGTYPES)
    err = entry(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                _build.DTYPE_CODES[a.dtype], E, C, d, h,
                torch.cuda.current_stream(a.device).cuda_stream,
                _build.PATHS.index(path))
    _build.check("moe_gemm_bwd", err, name)
    _build.count_launch(fn, path)
    return out


moe_gemm_dgrad.launches = 0
moe_gemm_dgrad.launches_by_path = {"wgmma": 0, "simt": 0}
moe_gemm_wgrad.launches = 0
moe_gemm_wgrad.launches_by_path = {"wgmma": 0, "simt": 0}
