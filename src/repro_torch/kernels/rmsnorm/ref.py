"""Plain PyTorch RMSNorm (optionally with residual add): the kernels' oracle.

Mirrors ``repro.kernels.rmsnorm.ref.rmsnorm_ref``: the residual add happens
in fp32 and the stored residual is rounded back to the input dtype.
``rmsnorm_bwd_ref`` is the backward kernel's oracle (the same arithmetic as
autograd of ``rmsnorm_ref`` without a residual, written out).
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


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """(dx, dw) of ``rmsnorm_ref(x, w, eps=eps)``: with rstd recomputed in
    fp32 and x^ = x rstd, dx = rstd (w dy - x^ mean(x^ w dy)) in x's dtype
    and dw = the sum over rows of dy x^ in w's dtype."""
    d = x.shape[-1]
    xf = x.float()
    g = dy.float() * w.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xh = xf * rstd
    dx = rstd * (g - xh * (xh * g).mean(-1, keepdim=True))
    dw = (dy.float() * xh).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)
