"""Device dispatch for the WKV6 recurrence: the plain version on a CPU
tensor, the CUDA kernel on a CUDA tensor (which launches or raises; there is
no fallback)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_fwd
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor, state=None):
    """r, k, v, w_log: (B, S, H, D); u: (H, D); state: (B, H, D, D) or None
    -> (y in r's dtype, final state fp32)."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w_log, u, state)
    return wkv6_fwd(r, k, v, w_log, u, state)
