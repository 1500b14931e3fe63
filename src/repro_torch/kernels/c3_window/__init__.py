from repro_torch.kernels.c3_window.ops import c3_window
from repro_torch.kernels.c3_window.ref import c3_window_ref

__all__ = ["c3_window", "c3_window_ref"]
