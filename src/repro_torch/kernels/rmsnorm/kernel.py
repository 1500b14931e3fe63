"""ctypes wrapper of the CUDA RMSNorm kernels (``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py:rmsnorm_fwd``.
``rmsnorm_fwd.launches`` counts the launches, and
``rmsnorm_fwd.launches_by_path`` counts them by kernel: ``"vector"`` (rows
wider than 1024 of whole 16-byte words on aligned bases: 16-byte loads, the
row in registers) and ``"simt"`` (the rest: scalar loads, a warp for each
narrow row).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _F, _P, _I]
# rows up to this width take a warp each in the scalar kernel
WARP_ROW_MAX = 1024
# the widest row the vector kernel holds: 512 threads x 4 words of 16 bytes
VECTOR_MAX_BYTES = 512 * 4 * 16


def rmsnorm_path(x: torch.Tensor, w: torch.Tensor, residual=None) -> str:
    """The kernel that takes x (..., d), w (d,) and the residual as they are
    handed to it (contiguous): ``"vector"`` where d > ``WARP_ROW_MAX``, a row
    is a whole number of 16-byte words, at most ``VECTOR_MAX_BYTES``, and
    every base is 16-byte aligned; else ``"simt"``."""
    d = x.shape[-1]
    row = d * x.element_size()
    bases = [x, w] + ([residual] if residual is not None else [])
    if d <= WARP_ROW_MAX or row % 16 or row > VECTOR_MAX_BYTES \
            or any(t.data_ptr() % 16 for t in bases):
        return "simt"
    return "vector"


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, residual=None,
                eps: float = 1e-5):
    """x: (..., d) on a CUDA device; w: (d,).  Optional fused residual add:
    returns (normalized x + r, x + r rounded to x's dtype).  The kernel is
    ``rmsnorm_path``'s choice."""
    d = x.shape[-1]
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device; "
                         f"got x on {x.device}, w on {w.device}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got "
                        f"x {x.dtype}, w {w.dtype}")
    if w.shape != (d,):
        raise ValueError(f"weight shape {tuple(w.shape)} != ({d},)")
    r = None
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype \
                or residual.device != x.device:
            raise ValueError("residual must match x in shape, dtype, device")
        r = residual.contiguous()
    x, w = x.contiguous(), w.contiguous()
    y, res = _launch(rmsnorm_path(x, w, r), x, w, r, eps)
    return (y, res) if residual is not None else y


def _launch(path: str, x: torch.Tensor, w: torch.Tensor, r=None,
            eps: float = 1e-5):
    """(y, x + r or None) from kernel ``path`` on the contiguous x, w and r
    that ``rmsnorm_fwd`` checked; a kernel that cannot take them fails at
    launch.  chip_smoke.py times the scalar kernel through it."""
    d = x.shape[-1]
    y = torch.empty_like(x)
    res = torch.empty_like(x) if r is not None else None
    rows = x.numel() // d if d else 0
    if rows:
        fn = _build.entry("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
        err = fn(x.data_ptr(), r.data_ptr() if r is not None else None,
                 w.data_ptr(), y.data_ptr(),
                 res.data_ptr() if res is not None else None,
                 _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[w.dtype],
                 rows, d, eps, torch.cuda.current_stream(x.device).cuda_stream,
                 _build.PATHS.index(path))
        _build.check("rmsnorm", err, "rmsnorm_fwd")
        _build.count_launch(rmsnorm_fwd, path)
    return y, res


rmsnorm_fwd.launches = 0
rmsnorm_fwd.launches_by_path = {"vector": 0, "simt": 0}
