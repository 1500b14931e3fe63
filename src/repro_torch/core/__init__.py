"""The port's copies of the numpy simulator and node power manager that the
Lit Silicon co-simulation hook drives (``repro.core``'s ``thermal``,
``workload``, ``c3sim``, ``detect``, ``mitigate``, ``backends`` and
``manager``; only their imports rewritten, and left out what the hook does
not reach: the cluster simulator and its backends, the fleet manager).  The
port cannot import ``repro.core``, whose package imports JAX.
"""
