"""The port's copies of the numpy simulator, the cluster simulator and the
power managers (``repro.core``'s ``thermal``, ``workload``, ``c3sim``,
``cluster``, ``topology``, ``faults``, ``detect``, ``mitigate``,
``backends`` and ``manager``; their imports rewritten), and
``torch_engine``, the counterpart of ``repro.core.jax_engine``: the window
arithmetic of ``C3Sim`` and ``ClusterSim`` under ``engine="torch"`` and the
Monte-Carlo fleet scan, over the CUDA window-scan kernel.  Left out until
the scenario API is ported: the escalation policy and telemetry (a
collector given to the fleet's classes raises).  The port cannot import
``repro.core``, whose package imports JAX.
"""
