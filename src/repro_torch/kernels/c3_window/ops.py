"""Device dispatch for the C3 window scan and its draws: the plain version
on CPU tensors, the CUDA kernel on CUDA tensors (which launches or raises;
there is no fallback)."""
from __future__ import annotations

import torch

from repro_torch.kernels.c3_window.kernel import (c3_window_draw_scan,
                                                  c3_window_scan,
                                                  jax_normal_draw)
from repro_torch.kernels.c3_window.ref import (c3_window_draw_ref,
                                               c3_window_ref, jax_normal_ref)


def c3_window(table: torch.Tensor, rate_f: torch.Tensor,
              rate_f_s: torch.Tensor, rm: torch.Tensor, rm_s: torch.Tensor,
              noise: torch.Tensor, gflop: torch.Tensor, gbyte: torch.Tensor,
              dur: torch.Tensor, G: int, emit: bool):
    """One iteration of every barrier group (``ref.c3_window_ref``'s
    contract): the full trace with ``emit``, else ``(t_iter, util)``."""
    fn = c3_window_ref if rate_f.device.type == "cpu" else c3_window_scan
    return fn(table, rate_f, rate_f_s, rm, rm_s, noise, gflop, gbyte, dur,
              G, emit)


def c3_window_draw(table: torch.Tensor, rate_f: torch.Tensor,
                   rate_f_s: torch.Tensor, rm: torch.Tensor,
                   rm_s: torch.Tensor, keys: torch.Tensor, datum: int,
                   sigma: torch.Tensor, base: torch.Tensor,
                   spike_p: torch.Tensor, spike_mult: torch.Tensor,
                   spike: bool, gflop: torch.Tensor, gbyte: torch.Tensor,
                   G: int):
    """One iteration of every barrier group with the noise drawn from JAX's
    streams (``ref.c3_window_draw_ref``'s contract): ``(t_iter, util)``."""
    fn = (c3_window_draw_ref if rate_f.device.type == "cpu"
          else c3_window_draw_scan)
    return fn(table, rate_f, rate_f_s, rm, rm_s, keys, datum, sigma, base,
              spike_p, spike_mult, spike, gflop, gbyte, G)


def jax_normal(keys: torch.Tensor, datum: int, M: int) -> torch.Tensor:
    """(S, M) float64 normals of ``fold_in(keys[s], datum)`` in JAX's
    layout."""
    fn = jax_normal_ref if keys.device.type == "cpu" else jax_normal_draw
    return fn(keys, datum, M)
