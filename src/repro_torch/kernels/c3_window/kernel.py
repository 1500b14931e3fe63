"""ctypes wrappers of the CUDA C3 window scan (``csrc/c3_window.cu``).

Replaces no Pallas kernel: the JAX package's ``engine="jax"`` runs the same
arithmetic as the XLA jit of ``_iteration_scan``
(``repro/core/jax_engine.py:198``).  Three entry points, each counting its
own launches: ``c3_window_scan`` (the read form: the noise given as
tensors), ``c3_window_draw_scan`` (the draw form: the noise drawn in the
kernel from JAX's threefry2x32 streams, summary mode) and
``jax_normal_draw`` (JAX's float64 normals, the fleet scan's TP jitter).
The scans' ``launches_by_path`` count by how a group's max is taken:
``"shuffle"`` (G a power of two that divides 32) or ``"shared"`` (the rest,
through shared memory).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_uint
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _P]
_DRAW_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _U, _P, _P, _P, _P, _I, _P, _P,
                  _L, _L, _I, _I, _I, _P, _P, _P]
_NORMAL_ARGTYPES = [_P, _U, _L, _L, _P, _P]
MAX_GROUP = 1024      # csrc/c3_window.cu: a group lies in one block


def c3_window_path(G: int) -> str:
    """How the kernel takes a group's max: ``"shuffle"`` for G in 1, 2, 4,
    8, 16, 32, else ``"shared"``."""
    return "shuffle" if G <= 32 and 32 % G == 0 else "shared"


def c3_window_scan(table: torch.Tensor, rate_f: torch.Tensor,
                   rate_f_s: torch.Tensor, rm: torch.Tensor,
                   rm_s: torch.Tensor, noise: torch.Tensor,
                   gflop: torch.Tensor, gbyte: torch.Tensor,
                   dur: torch.Tensor, G: int, emit: bool):
    """The kernel on the inputs of ``ref.c3_window_ref`` (contiguous CUDA
    tensors on one device, float64 but the int32 table); the same outputs."""
    L = rate_f.numel()
    S, Kc, P = noise.shape
    Km = dur.shape[1] if dur.dim() == 2 else -1
    tensors = (table, rate_f, rate_f_s, rm, rm_s, noise, gflop, gbyte, dur)
    if not rate_f.is_cuda or any(t.device != rate_f.device for t in tensors):
        raise ValueError(f"c3_window kernel needs CUDA tensors on one device; "
                         f"got {[str(t.device) for t in tensors]}")
    if table.dtype != torch.int32 or any(t.dtype != torch.float64
                                         for t in tensors[1:]):
        raise TypeError(f"c3_window kernel takes an int32 table and float64 "
                        f"data; got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("c3_window kernel takes contiguous tensors")
    if not 1 <= G <= MAX_GROUP or L == 0 or L % G or S * P != L \
            or table.dim() != 2 or table.shape[1] != 3 \
            or rate_f.shape != (L,) or rate_f_s.shape != (L,) \
            or rm.shape != (L // G,) or rm_s.shape != (L // G,) \
            or gflop.shape != (Kc,) \
            or gbyte.shape != (Kc,) or dur.shape != (L // G, Km):
        raise ValueError(
            f"c3_window kernel: G {G} (1..{MAX_GROUP}) must divide the "
            f"{L} lanes; got table {tuple(table.shape)}, rm "
            f"{tuple(rm.shape)}, noise {tuple(noise.shape)}, gflop "
            f"{tuple(gflop.shape)}, gbyte {tuple(gbyte.shape)}, dur "
            f"{tuple(dur.shape)}")
    dev, f64 = rate_f.device, torch.float64
    B = L // G
    if emit:
        outs = (torch.full((Kc, L), float("nan"), dtype=f64, device=dev),
                torch.full((Kc, L), float("nan"), dtype=f64, device=dev),
                torch.zeros((Kc, L), dtype=f64, device=dev),
                torch.empty((Km, L), dtype=f64, device=dev),
                torch.empty((B, Km), dtype=f64, device=dev),
                torch.empty(L, dtype=f64, device=dev))
    else:
        outs = (torch.empty(B, dtype=f64, device=dev),
                torch.empty(L, dtype=f64, device=dev))
    ptrs = [o.data_ptr() for o in outs] + [None] * (6 - len(outs))
    fn = _build.entry("c3_window", "c3_window", _ARGTYPES)
    err = fn(table.data_ptr(), table.shape[0], rate_f.data_ptr(),
             rate_f_s.data_ptr(), rm.data_ptr(), rm_s.data_ptr(),
             noise.data_ptr(), gflop.data_ptr(), gbyte.data_ptr(),
             dur.data_ptr(), L, P, G, Kc, Km, int(emit), *ptrs,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("c3_window", err, "c3_window")
    _build.count_launch(c3_window_scan, c3_window_path(G))
    return outs


c3_window_scan.launches = 0
c3_window_scan.launches_by_path = {"shuffle": 0, "shared": 0}


def _on_one_card(what: str, tensors) -> None:
    dev = tensors[0].device
    if not dev.type == "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs CUDA tensors on one device; "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")


def _keys(keys: torch.Tensor) -> int:
    if keys.dtype not in (torch.int32, torch.uint32) or keys.dim() != 2 \
            or keys.shape[1] != 2:
        raise TypeError(f"keys must be (S, 2) int32 or uint32 (JAX's raw "
                        f"uint32 keys); got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    return keys.shape[0]


def c3_window_draw_scan(table: torch.Tensor, rate_f: torch.Tensor,
                        rate_f_s: torch.Tensor, rm: torch.Tensor,
                        rm_s: torch.Tensor, keys: torch.Tensor, datum: int,
                        sigma: torch.Tensor, base: torch.Tensor,
                        spike_p: torch.Tensor, spike_mult: torch.Tensor,
                        spike: bool, gflop: torch.Tensor, gbyte: torch.Tensor,
                        G: int):
    """The draw form on the inputs of ``ref.c3_window_draw_ref`` (contiguous
    CUDA tensors on one device, float64 but the int32 table and keys); the
    same ``(t_iter, util)``."""
    data = (rate_f, rate_f_s, rm, rm_s, sigma, base, spike_p, spike_mult,
            gflop, gbyte)
    _on_one_card("c3_window draw", (table, keys) + data)
    S = _keys(keys)
    if table.dtype != torch.int32 or any(t.dtype != torch.float64
                                         for t in data):
        raise TypeError(f"c3_window draw kernel takes an int32 table and "
                        f"float64 data; got {[t.dtype for t in data]}")
    L, Kc = rate_f.numel(), gflop.numel()
    Km = base.shape[1] if base.dim() == 2 else -1
    if not 1 <= G <= MAX_GROUP or L == 0 or L % S or (L // S) % G \
            or table.dim() != 2 or table.shape[1] != 3 \
            or rate_f_s.shape != (L,) or rm.shape != (L // G,) \
            or rm_s.shape != (L // G,) or gbyte.shape != (Kc,) \
            or base.shape != (S, Km) or sigma.shape != (S,) \
            or spike_p.shape != (S,) or spike_mult.shape != (S,):
        raise ValueError(
            f"c3_window draw kernel: G {G} (1..{MAX_GROUP}) must divide each "
            f"of the {S} samples' lanes of {L}; got table "
            f"{tuple(table.shape)}, rm {tuple(rm.shape)}, base "
            f"{tuple(base.shape)}, sigma {tuple(sigma.shape)}")
    dev, f64 = rate_f.device, torch.float64
    t_iter = torch.empty(L // G, dtype=f64, device=dev)
    util = torch.empty(L, dtype=f64, device=dev)
    fn = _build.entry("c3_window", "c3_window_draw", _DRAW_ARGTYPES)
    err = fn(table.data_ptr(), table.shape[0], rate_f.data_ptr(),
             rate_f_s.data_ptr(), rm.data_ptr(), rm_s.data_ptr(),
             keys.data_ptr(), int(datum) & 0xFFFFFFFF, sigma.data_ptr(),
             base.data_ptr(), spike_p.data_ptr(), spike_mult.data_ptr(),
             int(bool(spike)), gflop.data_ptr(), gbyte.data_ptr(), L, L // S,
             G, Kc, Km, t_iter.data_ptr(), util.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("c3_window", err, "c3_window_draw")
    _build.count_launch(c3_window_draw_scan, c3_window_path(G))
    return t_iter, util


c3_window_draw_scan.launches = 0
c3_window_draw_scan.launches_by_path = {"shuffle": 0, "shared": 0}


def jax_normal_draw(keys: torch.Tensor, datum: int, M: int) -> torch.Tensor:
    """(S, M) float64: ``jax.random.normal(fold_in(keys[s], datum), (M,))``
    for each raw key (``prng.normal(prng.fold_in(keys, datum), (M,))``)."""
    _on_one_card("jax_normal", (keys,))
    S = _keys(keys)
    if M < 1:
        raise ValueError(f"jax_normal kernel: M must be positive; got {M}")
    out = torch.empty((S, M), dtype=torch.float64, device=keys.device)
    fn = _build.entry("c3_window", "jax_normal", _NORMAL_ARGTYPES)
    err = fn(keys.data_ptr(), int(datum) & 0xFFFFFFFF, S, M, out.data_ptr(),
             torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check("c3_window", err, "jax_normal")
    _build.count_launch(jax_normal_draw, "normal")
    return out


jax_normal_draw.launches = 0
jax_normal_draw.launches_by_path = {"normal": 0}
