"""ctypes wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py:rmsnorm_fwd``.
``rmsnorm_fwd.launches`` counts the launches of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _F, _P]


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, residual=None,
                eps: float = 1e-5):
    """x: (..., d) on a CUDA device; w: (d,).  Optional fused residual add:
    returns (normalized x + r, x + r rounded to x's dtype)."""
    d = x.shape[-1]
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device; "
                         f"got x on {x.device}, w on {w.device}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got "
                        f"x {x.dtype}, w {w.dtype}")
    if w.shape != (d,):
        raise ValueError(f"weight shape {tuple(w.shape)} != ({d},)")
    x = x.contiguous()
    w = w.contiguous()
    y = torch.empty_like(x)
    r = res = None
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype \
                or residual.device != x.device:
            raise ValueError("residual must match x in shape, dtype, device")
        r = residual.contiguous()
        res = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        fn = _build.entry("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
        err = fn(x.data_ptr(), r.data_ptr() if r is not None else None,
                    w.data_ptr(), y.data_ptr(),
                    res.data_ptr() if res is not None else None,
                    _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[w.dtype],
                    rows, d, eps, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check("rmsnorm", err, "rmsnorm_fwd")
        rmsnorm_fwd.launches += 1
    return (y, res) if residual is not None else y


rmsnorm_fwd.launches = 0
