"""Plain PyTorch RMSNorm (optionally with residual add): the kernel's oracle.

Mirrors ``repro.kernels.rmsnorm.ref.rmsnorm_ref``: the residual add happens
in fp32 and the stored residual is rounded back to the input dtype.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, residual=None,
                eps: float = 1e-5):
    """x: (..., d).  Returns normalized x (and the post-add residual)."""
    dt = x.dtype
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    y = (y * w.float()).to(dt)
    if residual is not None:
        return y, xf.to(dt)
    return y
