"""Parallelism of the port: the JAX package's sharding rules, the host mesh,
activation placement and FSDP (ZeRO-3) over the ``data`` axis; the torch
counterpart of ``repro.parallel``."""
