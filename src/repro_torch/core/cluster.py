"""Cluster-scale Lit Silicon: N thermally-independent nodes coupled by a
parallelism topology.

Each node runs the paper's intra-node C3/thermal dynamics (`NodeSim`).
Across nodes, the `Topology` (topology.py) maps the per-node local
iteration times plus a link model onto the fleet iteration time and per-node
lead signals: data parallelism adds a gradient ring all-reduce over the
slower inter-node fabric plus a global barrier (the paper's case — one hot
GPU straggles every node in the fleet); pipeline parallelism couples stages
point-to-point so a hot stage only bubbles the pipeline; tensor parallelism
syncs every layer on the fast link so waits happen inside collectives at
near-peak power.

Thermal feedback is wait-aware: under barrier/bubble topologies, nodes that
finish early idle and cool — the wasted provisioned power the
FleetPowerManager reallocates toward the straggler.  Under tensor
parallelism the waiters stay hot inside collective kernels and throttle
toward the straggler (tighter coupling).

Fleets may be heterogeneous (per-node `DevicePreset`, e.g. mixed air- and
liquid-cooled chassis) and may churn (per-node `ChurnModel` degrading
cooling over simulated time so stragglers emerge and migrate mid-run).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.c3sim import (IterationTrace, NodeSim, SimConfig,
                                    vector_iteration)
from repro_torch.core.faults import FaultModel
from repro_torch.core.thermal import PRESETS, ChurnModel, DevicePreset
from repro_torch.core.topology import Topology, make_topology, ring_allreduce_time
from repro_torch.core.torch_engine import torch_iteration
from repro_torch.core.workload import Workload

__all__ = ["ClusterConfig", "ClusterSim", "ring_allreduce_time"]


@dataclass
class ClusterConfig:
    n_nodes: int = 4
    inter_node_gbps: float = 12.5     # per-device effective inter-node GB/s
    grad_bytes: Optional[float] = None  # DP all-reduce payload per device;
    #                                     default: sum of the workload's
    #                                     gradient reduce-scatter payloads
    straggler_node: int = 0           # node hosting the hot GPU
    straggler_boost: float = 1.28     # r_th multiplier for that GPU
    healthy_boost: float = 1.0        # boost on every other node's worst slot
    engine: str = "batched"           # C3Sim engine for node iterations:
    #                                   "batched" | "event" | "vector" | "torch"
    #                                   (vector/torch batch all nodes per step;
    #                                   torch runs on SimConfig.device)
    # ---------------------------------------------------------- topology
    topology: str = "dp"              # dp | pp | tp (see topology.py)
    microbatches: int = 8             # PP: microbatches per iteration
    act_bytes: Optional[float] = None  # PP p2p / TP sync payload override;
    #                                    default: Workload.act_bytes
    tp_gbps: float = 300.0            # TP collectives ride the fast link
    tp_bytes: Optional[float] = None  # TP per-sync payload override
    tp_syncs: Optional[int] = None    # TP sync points; default 2 per layer
    tp_jitter: float = 0.01           # TP per-segment lognormal sigma
    tp_skew_cost: float = 1.0         # ring-collective stretch per unit of
    #                                   arrival skew at each sync point
    # ------------------------------------------------- fleet heterogeneity
    node_presets: Optional[Sequence[Union[str, DevicePreset]]] = None
    # per-node DevicePreset (or PRESETS name); default: the ClusterSim
    # `preset` argument on every node (homogeneous fleet)
    churn: Optional[Dict[int, ChurnModel]] = None
    # node index -> cooling-churn model for that node's devices


class ClusterSim:
    """N `NodeSim`s coupled by a parallelism `Topology`."""

    def __init__(self, workload: Workload, preset: DevicePreset,
                 sim_cfg: SimConfig, cluster_cfg: ClusterConfig,
                 devices_per_node: int = 8, seed: int = 0,
                 faults: Optional[FaultModel] = None,
                 fault_nodes: Optional[Sequence[int]] = None,
                 fault_t0: float = 0.0):
        cc = cluster_cfg
        self.cfg = cc
        self.N = cc.n_nodes
        self.G = devices_per_node
        self.sim_cfg = sim_cfg
        self.presets: List[DevicePreset] = self._resolve_presets(preset)
        self.preset = self.presets[0]
        if cc.engine == "jax":
            raise ValueError("engine 'jax' is the JAX package's; the port's "
                             "counterpart is engine 'torch'")
        node_engine = ("batched" if cc.engine in ("vector", "torch")
                       else cc.engine)
        node_sim_cfg = dataclasses.replace(sim_cfg, engine=node_engine)
        churn = cc.churn or {}
        self.nodes: List[NodeSim] = []
        for n in range(self.N):
            boost = (cc.straggler_boost if n == cc.straggler_node
                     else cc.healthy_boost)
            self.nodes.append(NodeSim(
                workload, self.presets[n],
                dataclasses.replace(node_sim_cfg, seed=sim_cfg.seed + n),
                n_devices=devices_per_node, seed=seed + 7919 * n,
                straggler_boost=boost, churn=churn.get(n)))
        grad = cc.grad_bytes
        if grad is None:
            grad = sum(c.bytes for c in workload.comm
                       if c.name.startswith("rs_"))
            if grad <= 0:
                grad = workload.total_bytes / 3.0
        self.grad_bytes = float(grad)
        self.topology: Topology = make_topology(
            cc, self.N, workload, self.grad_bytes, seed=seed)
        self.history: List[dict] = []
        self.iteration = 0
        # ---------------------------------------------------- fault injection
        # ``fault_nodes`` maps local node index -> global node id (an
        # escalation runner rebuilds smaller fleets after drains but fault
        # events keep naming the physical node they were scheduled on);
        # ``fault_t0`` offsets this fleet's clock onto the global sim clock.
        self.faults = faults
        self.fault_nodes: List[int] = (list(fault_nodes)
                                       if fault_nodes is not None
                                       else list(range(self.N)))
        if len(self.fault_nodes) != self.N:
            raise ValueError(f"fault_nodes has {len(self.fault_nodes)} "
                             f"entries for {self.N} nodes")
        self.t_sim = float(fault_t0)
        if faults is not None:
            faults.validate()
            for n, node in enumerate(self.nodes):
                gid = self.fault_nodes[n]
                node.thermal.rth_fault = (
                    lambda gid=gid: self.faults.rth_multipliers(
                        self.t_sim, gid, self.G))

    def _resolve_presets(self, preset: DevicePreset) -> List[DevicePreset]:
        np_cfg = self.cfg.node_presets
        if np_cfg is None:
            return [preset] * self.N
        if len(np_cfg) != self.N:
            raise ValueError(f"node_presets has {len(np_cfg)} entries for "
                             f"{self.N} nodes")
        return [PRESETS[p] if isinstance(p, str) else p for p in np_cfg]

    # ------------------------------------------------------------------ api
    def allreduce_time(self) -> float:
        """DP gradient ring all-reduce time (informational for pp/tp)."""
        return ring_allreduce_time(self.grad_bytes, self.N,
                                   self.cfg.inter_node_gbps)

    def set_node_caps(self, node: int, caps: np.ndarray) -> None:
        self.nodes[node].set_power_caps(caps)

    def get_node_caps(self, node: int) -> np.ndarray:
        return self.nodes[node].state.cap.copy()

    def _run_nodes(self) -> List[IterationTrace]:
        torch_engine = self.cfg.engine == "torch"
        if torch_engine or (self.cfg.engine == "vector" and self.N > 1):
            # one batched pass over all N*G lanes (numpy, or one launch of
            # the torch engine's kernel, one node included); per-node RNG
            # streams are drawn exactly as a per-node run would
            freqs, noises = [], []
            for node in self.nodes:
                f = node.state.freq.copy()
                if node.perf_scale is not None:
                    f = f * node.perf_scale
                node._freq_used = f
                freqs.append(node._freq_used)
                noises.append(node.sim._draw_noise())
            if torch_engine:
                return torch_iteration([n.sim for n in self.nodes], freqs,
                                       noises, device=self.sim_cfg.device)
            return vector_iteration([n.sim for n in self.nodes],
                                    freqs, noises)
        return [node.run_only() for node in self.nodes]

    def step(self) -> List[IterationTrace]:
        """One coupled iteration: all nodes execute locally, then the
        topology resolves the fleet time and per-node lead signals, and
        every node commits thermals over the stretched interval.

        With a ``FaultModel`` attached, active faults are applied first
        (compute-rate scales, step-time hangs), and the history row carries
        the ``sensor_dead`` mask telemetry observers must respect."""
        t_now = self.t_sim
        sensor_dead = None
        if self.faults is not None:
            for n, node in enumerate(self.nodes):
                node.perf_scale = self.faults.perf_scale(
                    t_now, self.fault_nodes[n], self.G)
            sensor_dead = np.array([self.faults.sensor_dead(t_now, g)
                                    for g in self.fault_nodes])
        traces = self._run_nodes()
        t_local = np.array([tr.t_iter for tr in traces])
        if self.faults is not None:
            hang = np.array([self.faults.hang_multiplier(t_now, g)
                             for g in self.fault_nodes])
            t_local = t_local * hang
        fs = self.topology.step(t_local)
        t_fleet = fs.t_fleet
        for node, tr in zip(self.nodes, traces):
            node.commit(tr, t_interval=t_fleet,
                        active_wait=self.topology.wait_active)
        power = np.array([float(np.sum(n.state.power)) for n in self.nodes])
        row = {
            "iter": self.iteration,
            "t_local": t_local,
            "t_fleet": t_fleet,
            "throughput": 1.0 / t_fleet,
            "node_power": power,
            "power": float(power.sum()),
            "slowest_node": int(np.argmax(t_local)),
            "lead": fs.lead,
            "comm_time": fs.comm_time,
            "topology": self.topology.name,
        }
        if self.faults is not None:
            row["t_sim"] = t_now
            row["sensor_dead"] = sensor_dead
        self.history.append(row)
        self.t_sim += t_fleet
        self.iteration += 1
        return traces

    # ------------------------------------------------------------ reporting
    def fleet_throughput(self, last: int = 30) -> float:
        h = self.history[-last:]
        return float(np.mean([x["throughput"] for x in h]))

    def fleet_power(self, last: int = 30) -> float:
        h = self.history[-last:]
        return float(np.mean([x["power"] for x in h]))
