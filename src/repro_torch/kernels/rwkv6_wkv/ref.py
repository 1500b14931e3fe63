"""Plain PyTorch WKV6 recurrence: the kernel's oracle.

Mirrors ``repro.kernels.rwkv6_wkv.ref.wkv6_ref``, the exact sequential scan
in fp32 from an optional initial state:

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(exp(w_t)) S_{t-1} + k_t^T v_t
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w_log: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w_log: (B, S, H, D); u: (H, D); state: (B, H, D, D) or None
    (zeros) -> (y (B, S, H, D) in r's dtype, final state (B, H, D, D) fp32)."""
    B, S, H, D = r.shape
    if state is None:
        state = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    state = state.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        rr, kk, vv, ww = (x[:, t].float() for x in (r, k, v, w_log))
        kv = kk[..., :, None] * vv[..., None, :]                # (B,H,D,D)
        ys.append(torch.einsum("bhd,bhde->bhe", rr, state + uf * kv))
        state = state * torch.exp(ww)[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), state
