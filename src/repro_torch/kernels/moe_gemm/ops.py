"""Device dispatch for the grouped expert GEMM: the plain version on a CPU
tensor, the CUDA kernel on a CUDA tensor (which launches or raises; there is
no fallback)."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm.kernel import moe_gemm_fwd
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, h) -> (E, C, h)."""
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    return moe_gemm_fwd(x, w)
