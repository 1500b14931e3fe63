"""Typed fault injection for the cluster simulator.

The paper's power managers *tune around* thermal stragglers; a production
fleet also faces stragglers no cap schedule can fix.  ``FaultModel`` is the
ChurnModel-style injector for those: a seeded schedule of typed
``FaultEvent``s that ``ClusterSim`` consults every step and applies to the
layer each fault physically lives in:

  * ``thermal_runaway`` — the device's thermal resistance *grows* from the
    onset (``magnitude`` = fractional r_th growth per simulated second), so
    temperature keeps climbing past any cap's reach and DVFS pins the
    device at f_min: the unrecoverable cousin of a ChurnEvent's one-shot
    degradation.  Applied through ``ThermalModel.rth_fault``.
  * ``perf_degrade`` — the device computes at ``magnitude`` x its clocked
    rate (ECC storms, row-remap retirements) while drawing normal power.
    Applied as a compute-rate scale in ``NodeSim.run_only``.
  * ``kernel_hang`` — the node's local step time is multiplied by
    ``magnitude`` while active (hung collective, network blip).  Applied to
    ``t_local`` before the topology couples the fleet.
  * ``sensor_death`` — the node's observed telemetry goes NaN/stale while
    active; the simulator itself is unaffected (only observers are blind).
  * ``device_loss`` — the device stops doing useful work (rate pinned to
    ``LOST_DEVICE_RATE``); only draining the node helps.

Events with a finite ``duration`` are *transient* (recoverable: ride them
out); ``thermal_runaway`` / ``device_loss`` / ``sensor_death`` — and any
fault left active forever — are *unrecoverable*: the EscalationPolicy
(escalate.py) is expected to drain the node, and draining a node with no
active unrecoverable fault counts as a false drain.

Node indices in events are **global** (position in the original fleet):
a rebuilt post-drain ClusterSim passes its surviving-node id map so
faults keep following the physical node they were scheduled on.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["FAULT_KINDS", "UNRECOVERABLE_KINDS", "FaultEvent", "FaultModel",
           "random_faults", "LOST_DEVICE_RATE"]

FAULT_KINDS = ("thermal_runaway", "perf_degrade", "kernel_hang",
               "sensor_death", "device_loss")

# kinds that never heal on their own, whatever their duration says
UNRECOVERABLE_KINDS = ("thermal_runaway", "device_loss", "sensor_death")

# compute-rate multiplier of a lost device: not 0 (the coupled step would
# never finish) but slow enough that the node is unambiguously dead weight
LOST_DEVICE_RATE = 0.05


@dataclass
class FaultEvent:
    """One injected fault: ``kind`` on ``node``/``device`` from simulated
    second ``t`` for ``duration`` seconds (default: forever)."""

    t: float
    kind: str
    node: int = 0
    device: int = 0                    # ignored by node-scoped kinds
    magnitude: float = 1.0             # kind-specific (see module docstring)
    duration: float = math.inf

    def active(self, t: float) -> bool:
        return self.t <= t < self.t + self.duration

    @property
    def unrecoverable(self) -> bool:
        return (self.kind in UNRECOVERABLE_KINDS
                or math.isinf(self.duration))

    def validate(self) -> "FaultEvent":
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        if self.duration <= 0:
            raise ValueError(f"fault duration must be > 0, got "
                             f"{self.duration}")
        return self


@dataclass
class FaultModel:
    """A seeded schedule of fault events (ChurnModel-style: pure data, all
    queries are functions of simulated time — no hidden state, so live runs
    and offline replays agree)."""

    events: List[FaultEvent] = field(default_factory=list)

    def validate(self) -> "FaultModel":
        for ev in self.events:
            ev.validate()
        return self

    # ------------------------------------------------------ per-step queries
    def _active(self, t: float, node: int, kind: str):
        return (ev for ev in self.events
                if ev.node == node and ev.kind == kind and ev.active(t))

    def rth_multipliers(self, t: float, node: int,
                        n_devices: int) -> np.ndarray:
        """thermal_runaway: r_th multiplier per device, growing linearly
        with time since onset (composes multiplicatively, like churn)."""
        m = np.ones(n_devices)
        for ev in self._active(t, node, "thermal_runaway"):
            m[ev.device] *= 1.0 + ev.magnitude * (t - ev.t)
        return m

    def perf_scale(self, t: float, node: int,
                   n_devices: int) -> Optional[np.ndarray]:
        """perf_degrade + device_loss: per-device compute-rate multiplier;
        None when nothing is active (keeps the hot path allocation-free)."""
        m = None
        for ev in self._active(t, node, "perf_degrade"):
            if m is None:
                m = np.ones(n_devices)
            m[ev.device] *= ev.magnitude
        for ev in self._active(t, node, "device_loss"):
            if m is None:
                m = np.ones(n_devices)
            m[ev.device] = min(m[ev.device], LOST_DEVICE_RATE)
        return m

    def hang_multiplier(self, t: float, node: int) -> float:
        """kernel_hang: node-level step-time multiplier (composes)."""
        m = 1.0
        for ev in self._active(t, node, "kernel_hang"):
            m *= max(ev.magnitude, 1.0)
        return m

    def sensor_dead(self, t: float, node: int) -> bool:
        return any(True for _ in self._active(t, node, "sensor_death"))

    # --------------------------------------------------------- introspection
    def events_for(self, node: int) -> List[FaultEvent]:
        return [ev for ev in self.events if ev.node == node]

    def onset_of_unrecoverable(self, node: int,
                               before: float = math.inf) -> Optional[float]:
        """Earliest onset of an unrecoverable fault on ``node`` that has
        started by simulated time ``before`` (None: the node is healthy —
        draining it would be a false drain)."""
        times = [ev.t for ev in self.events
                 if ev.node == node and ev.unrecoverable and ev.t <= before]
        return min(times) if times else None

    def activated_between(self, t0: float, t1: float,
                          nodes: Optional[Sequence[int]] = None
                          ) -> List[FaultEvent]:
        """Events whose onset falls in (t0, t1] — what a step that advanced
        the clock from t0 to t1 should report to the trace."""
        keep = None if nodes is None else set(nodes)
        return [ev for ev in self.events
                if t0 < ev.t <= t1 and (keep is None or ev.node in keep)]


def random_faults(seed: int, n_nodes: int, horizon_s: float,
                  rate_per_node_hour: float,
                  n_devices: int = 8,
                  kinds: Sequence[str] = FAULT_KINDS) -> List[FaultEvent]:
    """A seeded Poisson schedule of faults — the fleet-scale hazard model
    ("Not All GPUs Are Created Equal": hard faults arrive independently per
    node).  Magnitudes are drawn per kind in plausible ranges; transient
    kinds get finite durations."""
    rng = np.random.default_rng(seed)
    events: List[FaultEvent] = []
    rate_s = rate_per_node_hour / 3600.0
    for node in range(n_nodes):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate_s) if rate_s > 0 else math.inf
            if t >= horizon_s:
                break
            kind = str(rng.choice(list(kinds)))
            device = int(rng.integers(n_devices))
            if kind == "thermal_runaway":
                ev = FaultEvent(t, kind, node, device,
                                magnitude=float(rng.uniform(0.02, 0.10)))
            elif kind == "perf_degrade":
                ev = FaultEvent(t, kind, node, device,
                                magnitude=float(rng.uniform(0.4, 0.8)),
                                duration=float(rng.uniform(5.0, 60.0)))
            elif kind == "kernel_hang":
                ev = FaultEvent(t, kind, node,
                                magnitude=float(rng.uniform(1.5, 4.0)),
                                duration=float(rng.uniform(1.0, 10.0)))
            elif kind == "sensor_death":
                ev = FaultEvent(t, kind, node)
            else:                                           # device_loss
                ev = FaultEvent(t, kind, node, device)
            events.append(ev)
    return sorted(events, key=lambda e: e.t)
