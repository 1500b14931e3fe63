"""Device dispatch for flash attention: the plain version on a CPU tensor,
the CUDA kernel on a CUDA tensor (which launches or raises; no fallback)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, mask=None, *, causal: bool = False,
                    window: int = 0, q_offset: int = 0):
    """q: (B, Sq, H, D), k/v: (B, Sk, kvH, D) -> (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, mask, causal=causal,
                                   window=window, q_offset=q_offset)
    return flash_attention_fwd(q, k, v, mask, causal=causal, window=window,
                               q_offset=q_offset)
