"""Power backends: how the manager reads telemetry and sets caps.

The manager is oblivious to the telemetry source — the same property that
makes the paper's 200-line solution deployable.  ``SimBackend`` drives the
calibrated node simulator.  (The port's copy of ``repro.core.backends``:
``PowerBackend`` and ``SimBackend``, what the co-simulation hook reaches.)
"""
from __future__ import annotations

from typing import Protocol

import numpy as np

from repro_torch.core.c3sim import IterationTrace, NodeSim


class PowerBackend(Protocol):
    n_devices: int
    tdp: float

    def run_iteration(self) -> IterationTrace: ...
    def set_power_caps(self, caps: np.ndarray) -> None: ...
    def get_power_caps(self) -> np.ndarray: ...
    def telemetry(self) -> dict: ...


class SimBackend:
    """Backend over the discrete-event node simulator.  ``collector``
    (a ``repro.telemetry.TelemetryCollector``) attaches to the node so
    every committed iteration is offered to the trace recorder."""

    def __init__(self, node: NodeSim, collector=None):
        self.node = node
        self.n_devices = node.G
        self.tdp = node.thermal.preset.tdp
        if collector is not None:
            collector.attach_node(node)

    def run_iteration(self) -> IterationTrace:
        return self.node.step()

    def set_power_caps(self, caps: np.ndarray) -> None:
        self.node.set_power_caps(caps)

    def get_power_caps(self) -> np.ndarray:
        return self.node.state.cap.copy()

    def telemetry(self) -> dict:
        s = self.node.state
        return {"temp": s.temp.copy(), "freq": s.freq.copy(),
                "power": s.power.copy(), "cap": s.cap.copy()}
