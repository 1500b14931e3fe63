"""Device dispatch for RMSNorm: the plain version on a CPU tensor, the CUDA
kernels on a CUDA tensor (which launch or raise; there is no fallback).

Where autograd needs a gradient of a CUDA call, ``RMSNorm`` runs the forward
kernel and the backward kernel; on the CPU autograd differentiates the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd, rmsnorm_fwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


class RMSNorm(torch.autograd.Function):
    """The forward kernel and the backward kernel (no residual)."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_fwd(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, residual=None,
            eps: float = 1e-5):
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, residual, eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if residual is not None:
            raise NotImplementedError(
                "the RMSNorm backward kernel has no residual form (the models "
                "add the residual first)")
        return RMSNorm.apply(x, w, eps)
    return rmsnorm_fwd(x, w, residual, eps)
