"""Inter-node topologies: how parallelism strategy couples nodes to a
straggler.

The paper's node-level observation — one hot GPU stalls its peers through
concurrent execution — aggregates to the cluster through whatever dependency
structure the parallelism strategy imposes.  A `Topology` maps the per-node
local iteration times (from each node's `IterationTrace`) plus a link model
onto (a) the fleet iteration time, (b) a per-node *lead signal* the
hierarchical power manager consumes, and (c) whether inter-node waiting is
*active* (burns near-peak power inside collective kernels) or *idle* (the
device parks at a barrier and cools):

  DataParallel      ring all-reduce on the slow fabric + a global barrier.
                    Every node stretches to the slowest; waits are idle.
                    Lead = barrier wait.  (The paper's case, preserved
                    bit-for-bit from the original `ClusterSim`.)

  PipelineParallel  stage-to-stage point-to-point dependencies.  A hot stage
                    bubbles the pipeline, but the sum/M fill-drain term
                    dilutes its impact — strictly *weaker* coupling than the
                    barrier case, which upper-bounds it.  Lead = bubble
                    (idle) time per stage.

  TensorParallel    per-layer all-gather/reduce-scatter on the fast link:
                    many sync points per iteration expose per-segment jitter
                    (sum of per-segment maxima >= max of sums) and the waits
                    happen *inside* collective kernels at near-peak power,
                    heating the waiters — strictly *tighter* coupling than
                    the barrier case.  Lead = exposed collective wait.

"Characterizing the Efficiency of Distributed Training" (PAPERS.md) measures
exactly this strategy-dependence of thermal/power behavior on real fleets.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


def ring_allreduce_time(payload_bytes: float, n_nodes: int,
                        gbps: float) -> float:
    """Bandwidth term of a ring all-reduce: 2(N-1)/N chunks over the link."""
    if n_nodes <= 1 or payload_bytes <= 0:
        return 0.0
    return 2.0 * (n_nodes - 1) / n_nodes * payload_bytes / (gbps * 1e9)


def p2p_time(payload_bytes: float, gbps: float) -> float:
    """One point-to-point activation/grad transfer between adjacent stages."""
    if payload_bytes <= 0:
        return 0.0
    return payload_bytes / (gbps * 1e9)


@dataclass
class FleetStep:
    """One topology-resolved fleet iteration."""

    t_fleet: float                  # wall-clock of the coupled iteration
    lead: np.ndarray                # (N,) per-node lead signal (straggler ~0)
    comm_time: float                # exposed inter-node communication time
    info: Dict[str, float] = field(default_factory=dict)


class Topology(ABC):
    """Maps per-node local iteration times onto the fleet dependency
    structure.  Subclasses define `step`; `wait_active` tells the cluster
    whether inter-node waits keep devices hot (inside collective kernels)
    or let them idle and cool (barrier/bubble)."""

    name: str = "abstract"
    wait_active: bool = False       # True: waits burn near-peak power

    def __init__(self, n_nodes: int):
        self.N = int(n_nodes)

    @abstractmethod
    def step(self, t_local: np.ndarray) -> FleetStep:
        """Resolve one fleet iteration from (N,) local iteration times."""


class DataParallel(Topology):
    """Ring all-reduce over the slow inter-node fabric + global barrier.

    t_fleet = max(t_local) + allreduce; lead = barrier wait.  This is the
    original `ClusterSim` arithmetic, preserved bit-for-bit.
    """

    name = "dp"

    def __init__(self, n_nodes: int, grad_bytes: float, gbps: float):
        super().__init__(n_nodes)
        self.grad_bytes = float(grad_bytes)
        self.gbps = float(gbps)

    def comm_time(self) -> float:
        return ring_allreduce_time(self.grad_bytes, self.N, self.gbps)

    def step(self, t_local: np.ndarray) -> FleetStep:
        t_local = np.asarray(t_local, float)
        t_ar = self.comm_time()
        t_fleet = float(t_local.max()) + t_ar
        lead = t_local.max() - t_local          # barrier wait; straggler ~0
        return FleetStep(t_fleet, lead, t_ar)


class PipelineParallel(Topology):
    """N pipeline stages (one per node), M microbatches, 1F1B steady state.

    Per-microbatch stage time is t_local/M; the iteration takes the fill
    (sum of stage times) plus (M-1) beats of the slowest stage plus the
    exposed fill/drain point-to-point transfers:

        t_fleet = sum_s(t_s)/M + (M-1)/M * max_s(t_s) + p2p

    One hot stage only adds ~M/(N+M-1) of its excess to the fleet relative
    iteration time — the barrier (DP) case upper-bounds this coupling.  A
    stage's bubble (idle) time t_fleet - t_s is the lead signal: the hot
    stage has the least bubble, its downstream peers the most.
    """

    name = "pp"

    def __init__(self, n_nodes: int, act_bytes: float, gbps: float,
                 microbatches: int = 8):
        super().__init__(n_nodes)
        self.act_bytes = float(act_bytes)
        self.gbps = float(gbps)
        self.M = max(1, int(microbatches))

    def comm_time(self) -> float:
        # fill + drain: one fwd activation and one bwd grad hop per stage
        # boundary is exposed outside steady state
        return 2.0 * (self.N - 1) * p2p_time(self.act_bytes, self.gbps)

    def step(self, t_local: np.ndarray) -> FleetStep:
        t_local = np.asarray(t_local, float)
        tau = t_local / self.M
        t_compute = float(tau.sum() + (self.M - 1) * tau.max())
        t_fleet = t_compute + self.comm_time()
        lead = t_fleet - t_local                # bubble time; straggler min
        return FleetStep(t_fleet, lead, self.comm_time())


class TensorParallel(Topology):
    """Per-layer all-gather/reduce-scatter on the fast link.

    The iteration is cut into `n_syncs` segments, one per collective; every
    sync is a fleet-wide rendezvous, so the compute term is the *sum of
    per-segment maxima* — at least max(t_local), and strictly more under
    per-segment jitter (sum-of-maxes >= max-of-sums).  Two effects make
    this the tightest coupling of the three:

      * the collectives start *staggered* — there is no barrier in front of
        them, so a bandwidth-bound ring collective is gated on the latest
        rank at every chunk hop and its duration stretches by the arrival
        skew (`skew_cost` * (max - min) per sync).  DP pays the skew once,
        at the single barrier; TP pays it at every layer.
      * the waits happen inside collective kernels at near-peak power
        (`wait_active`): waiters heat up, throttle, and converge toward the
        straggler instead of cooling at a barrier.

    Collective payloads ride the fast TP link, so the constant bandwidth
    overhead itself is small.  Lead = exposed collective wait
    sum_k(max_j seg_jk - seg_ik); the straggler waits ~0.
    """

    name = "tp"
    wait_active = True

    def __init__(self, n_nodes: int, sync_bytes: float, gbps: float,
                 n_syncs: int = 16, jitter: float = 0.01,
                 skew_cost: float = 1.0, seed: int = 0):
        super().__init__(n_nodes)
        self.sync_bytes = float(sync_bytes)
        self.gbps = float(gbps)
        self.K = max(1, int(n_syncs))
        self.jitter = float(jitter)
        self.skew_cost = float(skew_cost)
        self.rng = np.random.default_rng(seed + 15485863)

    def comm_time(self) -> float:
        # AG + RS per sync point on the fast link
        return self.K * ring_allreduce_time(self.sync_bytes, self.N,
                                            self.gbps)

    def step(self, t_local: np.ndarray) -> FleetStep:
        t_local = np.asarray(t_local, float)
        N, K = self.N, self.K
        if self.jitter > 0 and N > 1:
            w = np.exp(self.rng.normal(0.0, self.jitter, (N, K)))
            w /= w.sum(axis=1, keepdims=True)   # rows sum to 1 exactly
        else:
            w = np.full((N, K), 1.0 / K)
        seg = t_local[:, None] * w              # (N, K) per-segment times
        seg_max = seg.max(axis=0)
        t_compute = float(seg_max.sum())
        t_skew = (self.skew_cost * float((seg_max - seg.min(axis=0)).sum())
                  if N > 1 else 0.0)
        t_fleet = t_compute + t_skew + self.comm_time()
        lead = (seg_max[None, :] - seg).sum(axis=1)  # exposed wait
        return FleetStep(t_fleet, lead, self.comm_time(),
                         info={"t_skew": t_skew})


TOPOLOGIES = {"dp": DataParallel, "pp": PipelineParallel,
              "tp": TensorParallel}


def make_topology(cfg, n_nodes: int, workload, grad_bytes: float,
                  seed: int = 0) -> Topology:
    """Build the topology named by ``cfg.topology`` from a `ClusterConfig`
    (duck-typed) and the workload's payload hints.

    Payload defaults: PP point-to-point and TP per-sync payloads are the
    per-layer activation size when the workload records it
    (`Workload.act_bytes`), else a grad_bytes-derived fallback; TP sync
    count defaults to 2 per layer (forward AG + backward RS).
    """
    kind = getattr(cfg, "topology", "dp")
    act = getattr(cfg, "act_bytes", None)
    if act is None:
        act = getattr(workload, "act_bytes", 0.0) or grad_bytes / 8.0
    if kind == "dp":
        return DataParallel(n_nodes, grad_bytes, cfg.inter_node_gbps)
    if kind == "pp":
        return PipelineParallel(n_nodes, act, cfg.inter_node_gbps,
                                microbatches=cfg.microbatches)
    if kind == "tp":
        syncs = cfg.tp_syncs
        if syncs is None:
            n_layers = getattr(workload, "n_layers", 0)
            syncs = 2 * n_layers if n_layers else max(1, len(workload.comm))
        tp_bytes = cfg.tp_bytes if cfg.tp_bytes is not None else act
        return TensorParallel(n_nodes, tp_bytes, cfg.tp_gbps,
                              n_syncs=syncs, jitter=cfg.tp_jitter,
                              skew_cost=cfg.tp_skew_cost, seed=seed)
    raise ValueError(f"unknown topology {kind!r} "
                     f"(expected one of {sorted(TOPOLOGIES)})")
