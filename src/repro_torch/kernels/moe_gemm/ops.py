"""Device dispatch for the grouped expert GEMM: the plain version on a CPU
tensor, the CUDA kernels on a CUDA tensor (which launch or raise; there is
no fallback).

A call that autograd needs a gradient of goes through ``_MoEGemm``: the
forward kernel, then the two transposed kernels (``moe_gemm_dgrad`` for x,
``moe_gemm_wgrad`` for w) in the backward; on the CPU the plain forward and
the plain backward.  A call without one launches the forward alone, as
serving does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm.kernel import (moe_gemm_dgrad,
                                                 moe_gemm_fwd,
                                                 moe_gemm_wgrad)
from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref, moe_gemm_ref


def _forward(x, w):
    return moe_gemm_ref(x, w) if x.device.type == "cpu" \
        else moe_gemm_fwd(x, w)


class _MoEGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        if x.device.type == "cpu":
            dx, dw = moe_gemm_bwd_ref(x, w, dy)
            return (dx if need_x else None), (dw if need_w else None)
        dy = dy.to(x.dtype).contiguous()
        return (moe_gemm_dgrad(dy, w) if need_x else None,
                moe_gemm_wgrad(x, dy) if need_w else None)


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, h) -> (E, C, h)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MoEGemm.apply(x, w)
    return _forward(x, w)
