"""Device dispatch for the C3 window scan: the plain version on CPU tensors,
the CUDA kernel on CUDA tensors (which launches or raises; there is no
fallback)."""
from __future__ import annotations

import torch

from repro_torch.kernels.c3_window.kernel import c3_window_scan
from repro_torch.kernels.c3_window.ref import c3_window_ref


def c3_window(table: torch.Tensor, rate_f: torch.Tensor,
              rate_f_s: torch.Tensor, rm: torch.Tensor, rm_s: torch.Tensor,
              noise: torch.Tensor, gflop: torch.Tensor, gbyte: torch.Tensor,
              dur: torch.Tensor, G: int, emit: bool):
    """One iteration of every barrier group (``ref.c3_window_ref``'s
    contract): the full trace with ``emit``, else ``(t_iter, util)``."""
    fn = c3_window_ref if rate_f.device.type == "cpu" else c3_window_scan
    return fn(table, rate_f, rate_f_s, rm, rm_s, noise, gflop, gbyte, dur,
              G, emit)
