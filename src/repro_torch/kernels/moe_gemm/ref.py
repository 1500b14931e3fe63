"""Plain PyTorch grouped (per-expert) GEMM: the kernel's oracle.

Mirrors ``repro.kernels.moe_gemm.ref.moe_gemm_ref``: fp32 accumulation,
one rounding to x's dtype.
"""
from __future__ import annotations

import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, h) -> (E, C, h) in x's dtype."""
    return torch.einsum("ecd,edh->ech", x.float(), w.float()).to(x.dtype)
