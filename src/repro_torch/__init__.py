"""PyTorch + CUDA port of the ``repro`` model substrate for NVIDIA Hopper.

A second package beside the JAX one (which stays the reference).  It
imports torch, numpy and the standard library only; the kernels under
``repro_torch.kernels`` are CUDA C++ built for ``sm_90a`` at first use.
"""
