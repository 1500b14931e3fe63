"""Device dispatch for flash attention: the plain version on a CPU tensor,
the CUDA kernels on a CUDA tensor (which launch or raise; no fallback).

Where autograd needs a gradient of a CUDA call, ``FlashAttention`` runs the
forward kernel, keeping its log-sum-exp, and the backward kernel; on the CPU
autograd differentiates the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def every_query_sees_a_key(Sq: int, Sk: int, *, causal: bool, window: int,
                           q_offset: int) -> bool:
    """Whether each query i (position i + q_offset) has a visible key in
    [0, Sk): causal needs every position >= 0, a window needs every
    position's first key (position - window + 1) below Sk."""
    if Sq == 0:
        return True
    if Sk == 0 or (causal and q_offset < 0):
        return False
    last = Sq - 1 + q_offset
    return not window or last - window + 1 <= Sk - 1


class FlashAttention(torch.autograd.Function):
    """The forward kernel (with its log-sum-exp) and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, *, causal: bool = False,
                    window: int = 0, q_offset: int = 0):
    """q: (B, Sq, H, D), k/v: (B, Sk, kvH, D) -> (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, mask, causal=causal,
                                   window=window, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if mask is not None:
            raise NotImplementedError(
                "the flash backward kernel takes no explicit mask")
        if not every_query_sees_a_key(q.shape[1], k.shape[1], causal=causal,
                                      window=window, q_offset=q_offset):
            raise ValueError(
                "the flash backward kernel needs every query to see a key: "
                "a row that sees none has no gradient the plain forward's "
                "would match")
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return flash_attention_fwd(q, k, v, mask, causal=causal, window=window,
                               q_offset=q_offset)
