"""Parallelism of the port: the JAX package's sharding rules, the host mesh,
activation placement, FSDP (ZeRO-3) over the ``data`` axis and tensor,
sequence and expert parallelism over the ``model`` axis; the torch
counterpart of ``repro.parallel``."""
