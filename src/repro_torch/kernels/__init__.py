"""Hand-written CUDA kernels of the port (sm_90a), one package per kernel.

Each package holds ``kernel.py`` (the ctypes wrapper that launches the CUDA
source in ``csrc/`` and counts its launches), ``ref.py`` (the plain PyTorch
version of the same function) and ``ops.py`` (dispatch on the tensor's
device: a CPU tensor takes the plain version, a CUDA tensor the kernel).
"""
