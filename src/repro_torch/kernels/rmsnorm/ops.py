"""Device dispatch for RMSNorm: the plain version on a CPU tensor, the CUDA
kernel on a CUDA tensor (which launches or raises; there is no fallback)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor, residual=None,
            eps: float = 1e-5):
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, residual, eps)
    return rmsnorm_fwd(x, w, residual, eps)
