"""Plain PyTorch grouped (per-expert) GEMM and its backward: the kernels'
oracles.

Mirrors ``repro.kernels.moe_gemm.ref.moe_gemm_ref``: fp32 accumulation,
one rounding to x's dtype.  The backward's two products round once to the
inputs' dtype, as XLA's autodiff of the bf16 einsum does.
"""
from __future__ import annotations

import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, h) -> (E, C, h) in x's dtype."""
    return torch.einsum("ecd,edh->ech", x.float(), w.float()).to(x.dtype)


def moe_gemm_dgrad_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy (E, C, h), w (E, d, h) -> dx = dy w^T (E, C, d) in w's dtype."""
    return torch.einsum("ech,edh->ecd", dy.float(), w.float()).to(w.dtype)


def moe_gemm_wgrad_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x (E, C, d), dy (E, C, h) -> dw = x^T dy (E, d, h), contracted over
    C, in x's dtype."""
    return torch.einsum("ecd,ech->edh", x.float(), dy.float()).to(x.dtype)


def moe_gemm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """The gradients of ``moe_gemm_ref(x, w)`` for an output gradient dy
    (E, C, h): dx (E, C, d) = dy w^T in x's dtype, dw (E, d, h) = x^T dy
    (contracted over C) in w's dtype."""
    return (moe_gemm_dgrad_ref(dy, w).to(x.dtype),
            moe_gemm_wgrad_ref(x, dy).to(w.dtype))
