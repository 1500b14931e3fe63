"""ctypes wrapper of the CUDA WKV6 recurrence (``csrc/wkv6.cu``).

Replaces the TPU kernel ``repro/kernels/rwkv6_wkv/kernel.py:wkv6_fwd``.
``wkv6_fwd.launches`` counts the launches, and ``wkv6_fwd.launches_by_path``
counts them by kernel: ``"split"`` (every base 16-byte aligned: the state
split over blocks and lanes in 4 x 4 tiles, inputs by TMA; one token from a
state in a kernel of its own) and ``"simt"`` (the rest: one thread per
state column).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I]
HEAD_DIMS = (16, 32, 64)        # the head sizes csrc/wkv6.cu is built for


def wkv6_path(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w_log: torch.Tensor, state: Optional[torch.Tensor] = None
              ) -> str:
    """The kernel that takes these (contiguous) inputs: ``"split"`` where
    r, k, v, w_log and the state (if given) start on 16-byte boundaries,
    which its TMA copies and vector loads need; else ``"simt"``."""
    bases = [r, k, v, w_log] + ([state] if state is not None else [])
    return "simt" if any(t.data_ptr() % 16 for t in bases) else "split"


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w_log: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, S, H, D) contiguous CUDA tensors of one dtype (float32
    or bfloat16); w_log: (B, S, H, D) float32 log-decay; u: (H, D) float32;
    state: (B, H, D, D) float32 or None (zeros).  Returns y (B, S, H, D) in
    r's dtype and the final state (B, H, D, D) float32, from the kernel
    ``wkv6_path`` picks."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w_log)):
        raise ValueError(f"expected r, k, v, w_log of one shape (B, S, H, D); "
                         f"got {[tuple(t.shape) for t in (r, k, v, w_log)]}")
    B, S, H, D = r.shape
    if u.shape != (H, D):
        raise ValueError(f"u shape {tuple(u.shape)} != ({H}, {D})")
    if state is not None and state.shape != (B, H, D, D):
        raise ValueError(f"state shape {tuple(state.shape)} != "
                         f"({B}, {H}, {D}, {D})")
    given = [r, k, v, w_log, u] + ([state] if state is not None else [])
    if not r.is_cuda or any(t.device != r.device for t in given):
        raise ValueError(f"wkv6 kernel needs CUDA tensors on one device; got "
                         f"{[str(t.device) for t in given]}")
    if r.dtype not in _build.DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"wkv6 kernel takes r, k, v all float32 or all "
                        f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in given[3:]):
        raise TypeError(f"wkv6 kernel takes w_log, u and state in float32; "
                        f"got {[t.dtype for t in given[3:]]}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("wkv6 kernel takes contiguous r, k, v, w_log, u and "
                         "state")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel has no instance for head size {D}; "
                         f"built for {HEAD_DIMS}")
    if S == 0:
        raise ValueError("wkv6 kernel needs at least one time step")
    return _launch(wkv6_path(r, k, v, w_log, state), r, k, v, w_log, u, state)


def _launch(path: str, r, k, v, w_log, u, state=None):
    """(y, final state) from kernel ``path`` on the inputs ``wkv6_fwd``
    checked; a kernel that cannot take them fails at launch.  chip_smoke.py
    times the one-column-a-thread kernel through it."""
    B, S, H, D = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    fn = _build.entry("wkv6", "wkv6_fwd", _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
             u.data_ptr(), state.data_ptr() if state is not None else None,
             y.data_ptr(), s_out.data_ptr(), _build.DTYPE_CODES[r.dtype],
             B, S, H, D, torch.cuda.current_stream(r.device).cuda_stream,
             _build.PATHS.index(path))
    _build.check("wkv6", err, "wkv6_fwd")
    _build.count_launch(wkv6_fwd, path)
    return y, s_out


wkv6_fwd.launches = 0
wkv6_fwd.launches_by_path = {"split": 0, "simt": 0}
