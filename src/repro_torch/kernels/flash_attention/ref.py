"""Plain PyTorch flash attention: the CUDA kernels' oracle and CPU path.

The same arithmetic as the forward kernel (and as the JAX package's
``"chunked"`` ``sdpa_flash``): an online softmax over key chunks with fp32
running max, sum and accumulator, masked scores at -1e30, P rounded to V's
dtype before P V, and l clamped at 1e-30.  Grouped-query heads are computed
grouped, so K/V are never repeated H-wide.

``flash_attention_bwd_ref`` is the backward kernel's oracle: the gradients
recomputed from q, k, v, the output, its log-sum-exp and dO, P = exp(score
- lse) with the forward's conventions.  Where every query sees some key it
equals autograd of ``flash_attention_ref``; a row that sees no key has lse
-1e30 and P 1 for every key.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _visible(Sq: int, k0: int, n: int, *, causal: bool, window: int,
             q_offset: int, device) -> torch.Tensor:
    """(Sq, n) bool: key k0 + j is visible to query i (position i +
    q_offset): j <= i + q_offset if causal, and j > i + q_offset - window
    for window > 0."""
    qi = (torch.arange(Sq, device=device) + q_offset)[:, None]
    ki = torch.arange(k0, k0 + n, device=device)[None, :]
    valid = torch.ones((Sq, n), dtype=torch.bool, device=device)
    if causal:
        valid &= ki <= qi
    if window:
        valid &= ki > qi - window
    return valid


def flash_attention_ref(q, k, v, mask=None, *, causal: bool = False,
                        window: int = 0, q_offset: int = 0,
                        chunk: int = 512, return_lse: bool = False):
    """q: (B, Sq, H, D), k/v: (B, Sk, kvH, D) -> (B, Sq, H, D), and with
    ``return_lse`` each row's log-sum-exp m + log l, (B, H, Sq) fp32.

    mask: optional (Sq, Sk) bool, applied together with causal and window
    (key j is visible to query i when j <= i + q_offset, and when
    j > i + q_offset - window for window > 0).
    """
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    dev = q.device
    qg = q.reshape(B, Sq, kvH, G, D).float()
    m = torch.full((B, kvH, G, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, kvH, G, Sq, 1), device=dev)
    acc = torch.zeros((B, kvH, G, Sq, D), device=dev)
    for j0 in range(0, Sk, chunk):
        kj, vj = k[:, j0:j0 + chunk], v[:, j0:j0 + chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj.float()) * D ** -0.5
        valid = _visible(Sq, j0, kj.shape[1], causal=causal, window=window,
                         q_offset=q_offset, device=dev)
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
    l = l.clamp_min(1e-30)
    out = acc / l
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, H, Sq)
    return out


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = False,
                            window: int = 0, q_offset: int = 0,
                            chunk: int = 512):
    """(dq, dk, dv) from q, o, do (B, Sq, H, D), k, v (B, Sk, kvH, D) and
    lse (B, H, Sq): per key chunk, P = exp(score - lse) (P rounded to V's
    dtype for dV, as the forward rounds it before P V), dP = dO V^T,
    delta = rowsum(dO O), dS = P (dP - delta) where the key is visible, 0
    where it is masked; dq, dk, dv in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    dev, scale = q.device, D ** -0.5
    qg = q.reshape(B, Sq, kvH, G, D).float()
    dog = do.reshape(B, Sq, kvH, G, D).float()
    delta = (dog * o.reshape(B, Sq, kvH, G, D).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]             # (B,kvH,G,Sq,1)
    lse = lse.float().reshape(B, kvH, G, Sq, 1)
    dq = torch.zeros((B, kvH, G, Sq, D), device=dev)
    dks, dvs = [], []
    for j0 in range(0, Sk, chunk):
        kj, vj = k[:, j0:j0 + chunk].float(), v[:, j0:j0 + chunk].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj) * scale
        valid = _visible(Sq, j0, kj.shape[1], causal=causal, window=window,
                         q_offset=q_offset, device=dev)
        p = torch.exp(torch.where(valid, s, NEG_INF) - lse)
        dvs.append(torch.einsum("bhgqk,bqhgd->bkhd",
                                p.to(v.dtype).float(), dog))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vj)
        ds = torch.where(valid, p * (dp - delta), 0.0)
        dq += torch.einsum("bhgqk,bkhd->bhgqd", ds, kj) * scale
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    dk = torch.cat(dks, 1).to(k.dtype) if dks else torch.zeros_like(k)
    dv = torch.cat(dvs, 1).to(v.dtype) if dvs else torch.zeros_like(v)
    return dq, dk, dv
