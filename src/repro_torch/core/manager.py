"""PowerManager: the paper's node-level power-management layer (§V).

Wires detection (Algorithm 1) and mitigation (Algorithms 2+3) into a running
training loop with the Table II knobs: sampling period, warm-up, window size,
aggregation, max adjustment, global/local scale — under one of three use
cases (Table I):

  GPU-Red      no node cap (node cap = G·TDP): leaders get capped down,
               straggler stays at TDP — power drops, throughput flat.
  GPU-Realloc  node cap below provisioned: straggler boosted, everyone
               shifted down uniformly — throughput up at equal node power.
  CPU-Slosh    node cap raised by idle-CPU budget sloshed to the devices —
               straggler boosted without capping leaders.

The converged cap distribution is reusable across runs (paper Fig 12): it
can be exported/imported, so detection is a one-time (or weekly) cost.

(The port's copy of ``repro.core.manager``: the node-level controller and
the fleet controller over ``ClusterSim``.  Telemetry is not ported: a
collector given to the fleet controller raises.  The serving objective
(``objective``, ``tail_*``, ``on_serve_iteration``) and the elastic-restart
entry points (``import_budgets``, ``adjust_node_budgets``) come with the
serving engine and the escalation runner that call them, ROADMAP.md item
22.)
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.backends import NO_COLLECTOR, PowerBackend
from repro_torch.core.c3sim import IterationTrace
from repro_torch.core.detect import lead_value_detect
from repro_torch.core.mitigate import adj_power_node, inc_power_gpu

USE_CASES = ("gpu-red", "gpu-realloc", "cpu-slosh")


@dataclass
class ManagerConfig:
    """Table II knobs (defaults = paper defaults)."""

    use_case: str = "gpu-red"
    sampling_period: int = 10          # sample 1 of every N iterations
    warmup: int = 50                   # samples before first adjustment
    window_size: int = 3               # samples averaged per adjustment
    aggregation: str = "sum"           # sum | max | last
    max_adjustment: float = 15.0       # W, Algorithm 2 max_inc
    scale: str = "global"              # global | local
    power_cap: float = 700.0           # per-GPU initial cap (Realloc/Slosh)
    cpu_budget: float = 20.0           # W per GPU sloshable (CPU-Slosh)
    convergence_freeze: bool = True    # disable after caps stabilize (§V:
    freeze_tol_w: float = 2.5          #   one-time profiling cost)
    freeze_window: int = 3
    node_cap_override: Optional[float] = None  # W: a fleet controller sets
    #                                    this to the node's current budget

    def node_cap(self, n_devices: int, tdp: float) -> float:
        if self.node_cap_override is not None:
            return self.node_cap_override
        if self.use_case == "gpu-red":
            return n_devices * tdp
        if self.use_case == "gpu-realloc":
            return n_devices * self.power_cap
        if self.use_case == "cpu-slosh":
            return n_devices * (self.power_cap + self.cpu_budget)
        raise ValueError(f"unknown use case {self.use_case!r}")

    def initial_caps(self, n_devices: int, tdp: float) -> np.ndarray:
        base = tdp if self.use_case == "gpu-red" else self.power_cap
        return np.full(n_devices, float(base))


class PowerManager:
    """Continuous measure-and-correct controller (paper Fig 8).

    Two telemetry paths:

      * **oracle** (default, ``sensor=None``): the exact kernel-start
        matrix the simulator produced, sampled every
        ``cfg.sampling_period`` iterations — arithmetic unchanged since
        the first version of this layer;
      * **sensor-backed** (``sensor=SensorModel(...)``): starts are
        observed through a noisy/quantized/dropping sensor, and the
        *sensor's* ``sample_period``/``phase_jitter`` decide which
        iterations yield a reading — what a deployment consuming
        rocm-smi-style counters sees.  A lossless sensor with
        ``sample_period == cfg.sampling_period`` reproduces the oracle
        path bit-for-bit.

    ``collector``, when given, records every applied cap vector as a
    ``ManagerAction`` so traces carry the mitigation decisions alongside
    the signals that caused them.
    """

    def __init__(self, backend: PowerBackend, cfg: ManagerConfig,
                 sensor=None, collector=None, collector_node: int = 0):
        self.backend = backend
        self.cfg = cfg
        self.sensor = sensor
        self.collector = collector
        self.collector_node = collector_node   # which node actions name
        self.G = backend.n_devices
        self.tdp = backend.tdp
        self.global_max = 0.0
        self.samples_seen = 0
        self.window: List[np.ndarray] = []
        self.lead_log: List[np.ndarray] = []
        self.adjust_log: List[np.ndarray] = []
        self.enabled = True
        self._last_iteration = -1
        backend.set_power_caps(cfg.initial_caps(self.G, self.tdp))

    # ----------------------------------------------------------------- hook
    def on_iteration(self, iteration: int,
                     trace: Optional[IterationTrace]) -> None:
        """Training-loop hook: called every iteration with the trace when
        this iteration was sampled (else None)."""
        if not self.enabled or trace is None:
            return
        if self.sensor is not None:
            if not self.sensor.take_sample(iteration):
                return
            start = self.sensor.observe_starts(trace.comp_start)
        else:
            if iteration % self.cfg.sampling_period:
                return
            start = trace.comp_start
        self._last_iteration = iteration
        lead = lead_value_detect(start, self.cfg.aggregation)
        self.lead_log.append(lead)
        self.samples_seen += 1
        if self.samples_seen <= self.cfg.warmup:
            return
        self.window.append(lead)
        if len(self.window) < self.cfg.window_size:
            return
        avg_lead = np.mean(self.window, axis=0)
        self.window.clear()
        self.adjust(avg_lead)

    def adjust(self, lead: np.ndarray) -> np.ndarray:
        """One Algorithm-2 + Algorithm-3 correction."""
        inc, self.global_max = inc_power_gpu(
            lead, self.cfg.max_adjustment, self.global_max, self.cfg.scale)
        caps = adj_power_node(inc, self.backend.get_power_caps(), self.tdp,
                              self.cfg.node_cap(self.G, self.tdp))
        self.backend.set_power_caps(caps)
        self.adjust_log.append(caps.copy())
        if self.collector is not None:
            self.collector.on_manager_action("caps", self._last_iteration,
                                             caps, node=self.collector_node)
        # one-time profiling: freeze once the cap distribution stabilizes
        w = self.cfg.freeze_window
        if (self.cfg.convergence_freeze and len(self.adjust_log) > w):
            recent = np.stack(self.adjust_log[-(w + 1):])
            if np.abs(np.diff(recent, axis=0)).max() < self.cfg.freeze_tol_w:
                self.enabled = False
        return caps

    # ------------------------------------------------------ cap persistence
    def export_caps(self, path: str) -> None:
        """Converged caps are reusable across workloads/knobs (Fig 12)."""
        caps = self.backend.get_power_caps()
        with open(path, "w") as f:
            json.dump({"use_case": self.cfg.use_case,
                       "caps": caps.tolist()}, f,
                      sort_keys=True, allow_nan=False)

    def import_caps(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        self.backend.set_power_caps(np.asarray(data["caps"], float))
        self.enabled = False               # one-time profiling cost amortized


@dataclass
class FleetManagerConfig(ManagerConfig):
    """Cluster-level knobs on top of the Table II node knobs."""

    cluster_power_budget: Optional[float] = None  # W total; default
    #                                               n_nodes * node_cap
    node_window_size: int = 3          # fleet samples per node adjustment
    max_node_adjustment: float = 60.0  # W of node-budget shift per step
    node_scale: str = "global"         # damping for the node-level Alg. 2


class FleetPowerManager:
    """Hierarchical Lit Silicon control for an N-node fleet.

    Two nested instances of the paper's detect→mitigate loop:

      * per node, an unmodified `PowerManager` runs Algorithms 1-3 over that
        node's kernel-start traces, within the node's current power budget;
      * across nodes, the *same* Algorithms 2+3 run at node granularity over
        the **topology-defined lead signal** (`ClusterSimBackend.node_leads`):
        barrier wait under data parallelism, bubble time under pipeline
        parallelism, exposed collective wait under tensor parallelism.  The
        straggling node has lead ~0 under all three and receives budget
        sloshed from the waiting nodes, projected onto the cluster budget.

    Heterogeneous fleets are supported: per-node TDPs (mixed presets) bound
    each node's budget and floor individually; the initial budget split is
    proportional to each node's provisioned cap.

    The node-level loop needs only one scalar per node per sample, i.e. the
    same O(small allgather) telemetry cost the paper's §VIII-B deployment
    sketch budgets for.
    """

    def __init__(self, backend, cfg: FleetManagerConfig, collector=None):
        if collector is not None:
            raise NotImplementedError(NO_COLLECTOR)
        if not hasattr(backend, "node_views"):
            raise TypeError("FleetPowerManager needs a cluster backend "
                            "exposing per-node views (ClusterSimBackend)")
        self.backend = backend
        self.cfg = cfg
        self._last_iteration = -1
        self.N = backend.n_nodes
        self.G = backend.n_devices
        self.tdp = backend.tdp
        self.node_tdps = np.asarray(
            getattr(backend, "node_tdps", np.full(self.N, self.tdp)), float)
        per_node_caps = np.array([cfg.node_cap(self.G, t)
                                  for t in self.node_tdps])
        self.cluster_budget = (cfg.cluster_power_budget
                               if cfg.cluster_power_budget is not None
                               else float(per_node_caps.sum()))
        # initial split proportional to each node's provisioned cap
        # (uniform when the fleet is homogeneous)
        self.node_budgets = (per_node_caps * self.cluster_budget
                             / per_node_caps.sum())
        self.node_cfgs = [dataclasses.replace(
            cfg, node_cap_override=float(b)) for b in self.node_budgets]
        self.managers = [PowerManager(v, c) for v, c in
                         zip(backend.node_views, self.node_cfgs)]
        self.node_global_max = 0.0
        self.samples_seen = 0
        self.lead_window: List[np.ndarray] = []
        self.budget_log: List[np.ndarray] = []

    # ----------------------------------------------------------------- hook
    def on_iteration(self, iteration: int,
                     traces: Optional[List[IterationTrace]]) -> None:
        if traces is None:
            return
        self._last_iteration = iteration
        for mgr, tr in zip(self.managers, traces):
            mgr.on_iteration(iteration, tr)
        if iteration % self.cfg.sampling_period:
            return
        lead = None
        if hasattr(self.backend, "node_leads"):
            lead = self.backend.node_leads()
        if lead is None:       # non-topology backend: barrier-wait fallback
            t_local = np.array([tr.t_iter for tr in traces])
            lead = t_local.max() - t_local
        self.samples_seen += 1
        if self.samples_seen <= self.cfg.warmup:
            return
        self.lead_window.append(np.asarray(lead, float))
        if len(self.lead_window) < self.cfg.node_window_size:
            return
        lead_avg = np.mean(self.lead_window, axis=0)
        self.lead_window.clear()
        self._adjust_from_lead(lead_avg)

    def _adjust_from_lead(self, lead: np.ndarray) -> np.ndarray:
        """Algorithms 2+3 at node granularity over the lead signal
        (the straggling node leads by ~0)."""
        inc, self.node_global_max = inc_power_gpu(
            lead, self.cfg.max_node_adjustment, self.node_global_max,
            self.cfg.node_scale)
        budgets = adj_power_node(inc, self.node_budgets,
                                 tdp=self.G * float(self.node_tdps.max()),
                                 node_cap=self.cluster_budget)
        # heterogeneous fleets: each node is individually bound by its own
        # provisioned silicon (no-op when all presets match)
        budgets = np.minimum(budgets, self.G * self.node_tdps)
        floor = self.G * self.node_tdps * 0.25
        budgets = np.maximum(budgets, floor)
        # flooring after the projection can overshoot the cluster budget:
        # claw the excess back from nodes with headroom above the floor
        excess = budgets.sum() - self.cluster_budget
        if excess > 0:
            headroom = budgets - floor
            total = headroom.sum()
            if total > 0:
                budgets -= headroom * min(1.0, excess / total)
        # ... and the TDP clip can strand watts *below* it: a straggler
        # pinned at its silicon bound keeps requesting budget the clip
        # discards while the uniform shift already took it from the other
        # nodes, bleeding total budget every cycle.  Hand the shortfall
        # back to nodes with headroom so the projection lands on the
        # budget simplex, not under it.
        deficit = self.cluster_budget - budgets.sum()
        if deficit > 0:
            headroom = self.G * self.node_tdps - budgets
            total = headroom.sum()
            if total > 0:
                budgets += headroom * min(1.0, deficit / total)
        self.node_budgets = budgets
        self.budget_log.append(budgets.copy())
        for n, mgr in enumerate(self.managers):
            if abs(mgr.cfg.node_cap_override - budgets[n]) > 1e-6:
                mgr.cfg.node_cap_override = float(budgets[n])
                mgr.enabled = True      # budget moved: resume adaptation
        return budgets


def run_fleet_closed_loop(backend, cfg: FleetManagerConfig, iterations: int,
                          tune_after: Optional[int] = None, collector=None):
    """Cluster counterpart of `run_closed_loop`: run `iterations` fleet
    steps, enabling hierarchical tuning from `tune_after` (default
    halfway).  Returns the FleetPowerManager."""
    mgr = FleetPowerManager(backend, cfg, collector=collector)
    tune_after = iterations // 2 if tune_after is None else tune_after
    enabled = False
    for i in range(iterations):
        if i == tune_after:
            enabled = True
        traces = backend.run_iteration()
        if enabled:
            mgr.on_iteration(i, traces)
    return mgr


def run_closed_loop(backend: PowerBackend, cfg: ManagerConfig,
                    iterations: int, tune_after: Optional[int] = None,
                    sensor=None, collector=None):
    """Convenience driver: run `iterations`, tuning from `tune_after` on
    (default: halfway, as in paper Fig 9).  Returns the PowerManager (the
    node's history lives on ``backend.node.history``).  ``sensor``/
    ``collector`` flow into the ``PowerManager`` (telemetry-backed
    detection / action recording); defaults leave the oracle path
    untouched."""
    mgr = PowerManager(backend, cfg, sensor=sensor, collector=collector)
    tune_after = iterations // 2 if tune_after is None else tune_after
    mgr.enabled = False
    for i in range(iterations):
        if i == tune_after:
            mgr.enabled = True
        trace = backend.run_iteration()
        mgr.on_iteration(i, trace)
    return mgr
