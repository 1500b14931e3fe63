"""Plain PyTorch flash attention: the CUDA kernel's oracle and CPU path.

The same arithmetic as the kernel (and as the JAX package's ``"chunked"``
``sdpa_flash``): an online softmax over key chunks with fp32 running max,
sum and accumulator, masked scores at -1e30, P rounded to V's dtype before
P V, and l clamped at 1e-30.  Grouped-query heads are computed grouped, so
K/V are never repeated H-wide.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, mask=None, *, causal: bool = False,
                        window: int = 0, q_offset: int = 0,
                        chunk: int = 512):
    """q: (B, Sq, H, D), k/v: (B, Sk, kvH, D) -> (B, Sq, H, D).

    mask: optional (Sq, Sk) bool, applied together with causal and window
    (key j is visible to query i when j <= i + q_offset, and when
    j > i + q_offset - window for window > 0).
    """
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    dev = q.device
    qg = q.reshape(B, Sq, kvH, G, D).float()
    qi = (torch.arange(Sq, device=dev) + q_offset)[:, None]
    m = torch.full((B, kvH, G, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, kvH, G, Sq, 1), device=dev)
    acc = torch.zeros((B, kvH, G, Sq, D), device=dev)
    for j0 in range(0, Sk, chunk):
        kj, vj = k[:, j0:j0 + chunk], v[:, j0:j0 + chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj.float()) * D ** -0.5
        ki = torch.arange(j0, j0 + kj.shape[1], device=dev)[None, :]
        valid = torch.ones((Sq, kj.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            valid &= ki <= qi
        if window:
            valid &= ki > qi - window
        if mask is not None:
            valid &= mask[:, j0:j0 + chunk]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vj.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
