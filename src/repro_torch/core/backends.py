"""Power backends: how the manager reads telemetry and sets caps.

The manager is oblivious to the telemetry source — the same property that
makes the paper's 200-line solution deployable.  ``SimBackend`` drives the
calibrated node simulator; ``ClusterSimBackend`` the N-node cluster
simulator, with a ``NodeViewBackend`` per node.  (The port's copy of
``repro.core.backends``, without the TPU platform stub.  Telemetry is not
ported: a collector given to ``ClusterSimBackend`` raises.)
"""
from __future__ import annotations

from typing import List, Optional, Protocol

import numpy as np

from repro_torch.core.c3sim import IterationTrace, NodeSim
from repro_torch.core.cluster import ClusterSim

# what a collector given to the fleet's classes names: the telemetry stack
# comes with the scenario API
NO_COLLECTOR = ("telemetry collectors are not ported yet (ROADMAP.md item "
                "22, the scenario API: obs/, telemetry/); pass "
                "collector=None")


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


class NodeViewBackend:
    """Per-node cap/telemetry view over a cluster — satisfies the parts of
    ``PowerBackend`` a `PowerManager` touches (caps + metadata), so the
    unmodified node-level controller runs against one node of a fleet."""

    def __init__(self, cluster: ClusterSim, node: int):
        self.cluster = cluster
        self.node = node
        self.n_devices = cluster.G
        self.tdp = cluster.presets[node].tdp

    def run_iteration(self) -> IterationTrace:
        raise NotImplementedError(
            "NodeViewBackend is cap/telemetry only; iterations are driven "
            "fleet-wide through ClusterSimBackend.run_iteration")

    def set_power_caps(self, caps: np.ndarray) -> None:
        self.cluster.set_node_caps(self.node, caps)

    def get_power_caps(self) -> np.ndarray:
        return self.cluster.get_node_caps(self.node)

    def telemetry(self) -> dict:
        s = self.cluster.nodes[self.node].state
        return {"temp": s.temp.copy(), "freq": s.freq.copy(),
                "power": s.power.copy(), "cap": s.cap.copy()}


class ClusterSimBackend:
    """Backend over the N-node cluster simulator.  ``run_iteration`` returns
    the per-node traces of one data-parallel step; per-node cap control is
    exposed through `NodeViewBackend` views."""

    def __init__(self, cluster: ClusterSim, collector=None):
        self.cluster = cluster
        self.n_nodes = cluster.N
        self.n_devices = cluster.G
        self.tdp = cluster.preset.tdp
        self.node_tdps = np.array([p.tdp for p in cluster.presets])
        self.node_views = [NodeViewBackend(cluster, n)
                           for n in range(cluster.N)]
        if collector is not None:
            raise NotImplementedError(NO_COLLECTOR)

    def run_iteration(self) -> List[IterationTrace]:
        return self.cluster.step()

    def node_leads(self) -> Optional[np.ndarray]:
        """Topology-defined per-node lead signal of the last fleet step:
        barrier wait (DP), bubble time (PP), or exposed collective wait
        (TP).  The straggling node leads by ~0 under all three."""
        h = self.cluster.history
        return h[-1]["lead"] if h else None

    def set_power_caps(self, caps: np.ndarray) -> None:
        caps = np.asarray(caps, float).reshape(self.n_nodes, self.n_devices)
        for n in range(self.n_nodes):
            self.cluster.set_node_caps(n, caps[n])

    def get_power_caps(self) -> np.ndarray:
        return np.stack([self.cluster.get_node_caps(n)
                         for n in range(self.n_nodes)])

    def telemetry(self) -> dict:
        return {"nodes": [v.telemetry() for v in self.node_views],
                "t_fleet": (self.cluster.history[-1]["t_fleet"]
                            if self.cluster.history else None)}
