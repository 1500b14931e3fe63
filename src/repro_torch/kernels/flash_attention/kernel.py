"""ctypes wrappers of the CUDA flash-attention kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``).

``flash_attention_fwd`` replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_fwd`` (both its
index-masked and its explicit-mask forms) and can also return each row's
fp32 log-sum-exp for the backward.  ``flash_attention_fwd.launches`` counts
its launches, and ``flash_attention_fwd.launches_by_path`` counts them by
kernel: ``"wgmma"`` (bf16, D 64 or 128: tensor cores, TMA) and ``"simt"``
(the rest: CUDA cores).

``flash_attention_bwd`` is the port's backward (the TPU kernel has none):
dQ, dK and dV from q, k, v, the output, its log-sum-exp and dO, in one call
of three kernels on the CUDA cores, counted once per call
(``flash_attention_bwd.launches``, path ``"simt"``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import NEG_INF

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I,
             _I, _F, _P, _I]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 10 + [_F, _P]
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)


def head_strides(t: torch.Tensor) -> tuple:
    """Element strides (batch, seq, head) of a (B, S, H, D) tensor, where a
    dim of size 1 (whose stride is never used) reads as D."""
    (B, S, H, D), st = t.shape, t.stride()
    return (st[0] if B > 1 else D, st[1] if S > 1 else D,
            st[2] if H > 1 else D)


def flash_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these inputs: ``"wgmma"`` for bf16 with D 64 or
    128, ``"simt"`` for the rest (fp32, D 16 and 32).

    The wgmma kernel reads q, k and v through TMA, which needs 16-byte
    aligned bases and strides that are multiples of 16 bytes; inputs that
    break this raise ValueError (they are not sent elsewhere).
    """
    if q.dtype != torch.bfloat16 or q.shape[-1] not in WGMMA_HEAD_DIMS:
        return "simt"
    for name, t in (("q", q), ("k", k), ("v", v)):
        sb, ss, sh = head_strides(t)
        if t.stride(3) != 1 or t.data_ptr() % 16 or (sb | ss | sh) % 8:
            raise ValueError(
                f"flash kernel: {name} (strides {tuple(t.stride())}, base "
                f"{t.data_ptr() % 16} bytes past 16-byte alignment) cannot be "
                f"read by TMA: it needs a unit stride on D, a 16-byte aligned "
                f"base and (batch, seq, head) strides of whole 16 bytes")
    return "wgmma"


def flash_attention_fwd(q, k, v, mask=None, *, causal: bool = False,
                        window: int = 0, q_offset: int = 0,
                        return_lse: bool = False):
    """q: (B, Sq, H, D), k/v: (B, Sk, kvH, D) CUDA tensors -> (B, Sq, H, D),
    and with ``return_lse`` also each row's log-sum-exp (B, H, Sq) fp32 of
    its scaled, masked scores (-1e30 for a row that sees no key).

    Any strides with a unit stride on D are read in place (for bf16 with D
    64 or 128, strides TMA can take: see ``flash_path``).  mask: optional
    (Sq, Sk) bool, combined with the causal/window conditions.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Sq,H,D), k/v (B,Sk,kvH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash kernel needs CUDA tensors on one device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one of float32/bfloat16 for q, k "
                        f"and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS or k.shape[0] != B or k.shape[3] != D \
            or kvH == 0 or H % kvH:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (D in {HEAD_DIMS}, H % kvH == 0)")
    if mask is not None:
        if mask.shape != (Sq, Sk) or mask.dtype != torch.bool \
                or mask.device != q.device:
            raise ValueError(f"mask must be a ({Sq}, {Sk}) bool tensor on "
                             f"{q.device}")
        mask = mask.contiguous()
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0 or Sk == 0:
        if lse is not None:
            lse.fill_(NEG_INF)
        return (o.zero_(), lse) if return_lse else o.zero_()
    path = flash_path(q, k, v)
    strides = (ctypes.c_longlong * 9)(*head_strides(q), *head_strides(k),
                                      *head_strides(v))
    fn = _build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             mask.data_ptr() if mask is not None else None, o.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             _build.DTYPE_CODES[q.dtype], B, Sq, Sk, H, kvH, D, strides,
             int(causal), int(window), int(q_offset), D ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream,
             _build.PATHS.index(path))
    _build.check("flash_attention", err, "flash_attention_fwd")
    _build.count_launch(flash_attention_fwd, path)
    return (o, lse) if return_lse else o


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_path = {"wgmma": 0, "simt": 0}


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention_fwd(q, k, v, causal=..., window=...,
    q_offset=...)`` for CUDA tensors: q, o, do (B, Sq, H, D) and k, v (B,
    Sk, kvH, D) of one dtype (float32 or bfloat16), lse (B, H, Sq) fp32 from
    the forward.  No explicit mask.  The gradients come back contiguous in
    q's dtype, dk and dv summed over each kv head's group of query heads.
    For a row that sees no key the result follows the plain backward's
    convention (``flash_attention_bwd_ref``), not autograd's."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"expected q, o, do (B,Sq,H,D) and k, v (B,Sk,kvH,D); "
                         f"got {[tuple(t.shape) for t in (q, k, v, o, do)]}")
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    given = (q, k, v, o, lse, do)
    if not q.is_cuda or any(t.device != q.device for t in given):
        raise ValueError(f"flash backward needs CUDA tensors on one device; "
                         f"got {[str(t.device) for t in given]}")
    if q.dtype not in _build.DTYPE_CODES or any(
            t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError(f"flash backward takes one of float32/bfloat16 for q, "
                        f"k, v, o and do; got "
                        f"{[t.dtype for t in (q, k, v, o, do)]}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {Sq}) float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if D not in HEAD_DIMS or k.shape[0] != B or k.shape[3] != D \
            or kvH == 0 or H % kvH:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (D in {HEAD_DIMS}, H % kvH == 0)")
    q, k, v, o, lse, do = (t.contiguous() for t in given)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if Sq == 0 or Sk == 0 or B * H == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    fn = _build.entry("flash_attention_bwd", "flash_attention_bwd",
                      _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), _build.DTYPE_CODES[q.dtype], B, Sq,
             Sk, H, kvH, D, int(causal), int(window), int(q_offset),
             D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention_bwd", err, "flash_attention_bwd")
    _build.count_launch(flash_attention_bwd, "simt")
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_path = {"simt": 0}
