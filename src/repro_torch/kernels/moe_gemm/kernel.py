"""ctypes wrapper of the CUDA grouped expert GEMM (``csrc/moe_gemm.cu``).

Replaces the TPU kernel ``repro/kernels/moe_gemm/kernel.py:moe_gemm_fwd``.
``moe_gemm_fwd.launches`` counts the launches, and
``moe_gemm_fwd.launches_by_path`` counts them by kernel: ``"wgmma"`` (bf16
that TMA can read: tensor cores), ``"wmma"`` (bf16 that it cannot: d or h not
a multiple of 8, or an unaligned base) and ``"simt"`` (fp32: CUDA cores).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I]


def moe_gemm_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel that takes x (E, C, d), w (E, d, h): ``"simt"`` for fp32;
    for bf16 ``"wgmma"`` where TMA can read both (d > 0, d and h multiples of
    8, 16-byte aligned bases), else ``"wmma"``."""
    if x.dtype != torch.bfloat16:
        return "simt"
    d, h = x.shape[2], w.shape[2]
    tma = d > 0 and d % 8 == 0 and h % 8 == 0 and \
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "wgmma" if tma else "wmma"


def moe_gemm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, h) contiguous CUDA tensors of one dtype
    (float32 or bfloat16) -> (E, C, h) in that dtype."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"expected x (E, C, d) and w (E, d, h); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"moe_gemm kernel needs CUDA tensors on one device; "
                         f"got x on {x.device}, w on {w.device}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"moe_gemm kernel takes float32 or bfloat16 for both "
                        f"x and w; got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gemm kernel takes contiguous x and w")
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
