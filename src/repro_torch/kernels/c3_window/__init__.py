from repro_torch.kernels.c3_window.ops import c3_window, c3_window_draw, jax_normal
from repro_torch.kernels.c3_window.ref import (c3_window_draw_ref,
                                               c3_window_ref, jax_normal_ref)

__all__ = ["c3_window", "c3_window_draw", "jax_normal", "c3_window_ref",
           "c3_window_draw_ref", "jax_normal_ref"]
