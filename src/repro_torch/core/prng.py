"""A plain replay of ``jax.random``'s threefry2x32 streams in PyTorch.

It replays JAX 0.9 with ``jax_threefry_partitionable=True`` (the default
there) and the default ``threefry2x32`` PRNG, on raw uint32 keys of shape
(2,): the keys that ``build_fleet_arrays`` puts under ``arrays["key"]``.
Every function takes a leading key axis, keys of shape (S, 2), and draws
the same numbers that JAX draws from each of the S keys alone.

The layout it follows:

  * ``threefry2x32(k, x0, x1)`` is Random123's 20-round Threefry-2x32 on a
    key (k0, k1) and one counter pair;
  * ``fold_in(k, d)`` is ``threefry2x32(k, 0, d)`` for a 32-bit datum d,
    and ``split(k, n)[j]`` is ``threefry2x32(k, 0, j)``;
  * a draw of shape ``shape`` gives the element of flat index c the counter
    pair (hi, lo) = (c >> 32, c & 0xffffffff), and ``threefry2x32(k, hi,
    lo)`` gives the words (x0, x1): a 64-bit draw is ``x0 << 32 | x1``, a
    32-bit draw ``x0 ^ x1``;
  * a float64 uniform on [lo, hi) is ``max(lo, u (hi - lo) + lo)`` with u
    the 52 high bits of the 64-bit draw as a mantissa of [1, 2), less 1;
  * a float64 normal is ``sqrt(2) erfinv(u)`` with u uniform on
    [nextafter(-1, 0), 1).

All 32-bit words are int64 tensors holding values in [0, 2^32): every add
is masked back to 32 bits and no product is taken, so nothing overflows.
64-bit draws are int64 with the bits of the uint64 (``.view`` of a numpy
copy as uint64 gives JAX's values).  ``torch.special.erfinv`` on the CPU is
not XLA's ``erf_inv`` (they differ in the last bits), so normals agree with
JAX's to about 1e-12 relative there; on the card it is the CUDA math
library's ``erfinv``, the function the fleet simulator's kernel calls
(``kernels/csrc/c3_window.cu``), so there the two agree to the bit.

This module is the plain version of the kernel's draws and the CPU's path.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

__all__ = ["threefry2x32", "fold_in", "split", "words", "bits64", "uniform",
           "normal"]

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
ONE_BITS = 0x3FF0000000000000          # 1.0 as float64 bits
MANTISSA = (1 << 52) - 1
SQRT2 = math.sqrt(2.0)
NORMAL_LO = math.nextafter(-1.0, 0.0)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on broadcasting int64 tensors of 32-bit
    words: the key (k0, k1) and the counter (x0, x1); returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _as_keys(keys) -> torch.Tensor:
    keys = torch.as_tensor(keys)
    if keys.shape[-1:] != (2,):
        raise ValueError(f"keys must end in an axis of 2 words; got "
                         f"{tuple(keys.shape)}")
    return keys.to(torch.int64) & MASK


def fold_in(keys, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for each key of ``keys`` (..., 2)."""
    keys = _as_keys(keys)
    d = torch.full_like(keys[..., 0], int(data) & MASK)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(d), d)
    return torch.stack((y0, y1), dim=-1)


def split(keys, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)`` for each key: (..., 2) -> (..., n, 2)."""
    keys = _as_keys(keys)[..., None, :]
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(j), j)
    return torch.stack((y0, y1), dim=-1)


def words(keys, counters: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two 32-bit words of each key (S, 2) at each flat counter (any
    int64 shape): (x0, x1) of shape (S, *counters.shape)."""
    keys = _as_keys(keys)
    c = counters.to(torch.int64)
    k = keys.view(keys.shape[0], *([1] * c.dim()), 2)
    return threefry2x32(k[..., 0], k[..., 1], c >> 32, c & MASK)


def _counters(shape: Sequence[int], device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).view(tuple(shape))


def bits64(keys, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint64)`` per key, as int64 bits."""
    keys = _as_keys(keys)
    x0, x1 = words(keys, _counters(shape, keys.device))
    return (x0 - ((x0 >> 31) << 32)) * (1 << 32) + x1   # x0 << 32 | x1


def uniform(keys, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float64, minval, maxval)`` per key:
    the 52 high bits of the 64-bit draw as the mantissa of a float in
    [1, 2), less 1, then scaled to [minval, maxval)."""
    keys = _as_keys(keys)
    mant = ((bits64(keys, shape) >> 12) & MANTISSA) | ONE_BITS
    u = mant.view(torch.float64) - 1.0
    lo = torch.tensor(minval, dtype=torch.float64, device=keys.device)
    return torch.maximum(lo, u * (float(maxval) - float(minval)) + lo)


def normal(keys, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(k, shape, float64)`` per key: the plain version
    of the ``jax_normal`` kernel."""
    u = uniform(keys, shape, NORMAL_LO, 1.0)
    return SQRT2 * torch.special.erfinv(u)
