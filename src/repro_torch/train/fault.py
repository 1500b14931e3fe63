"""Fault tolerance: the step watchdog.

(The port's copy of ``Watchdog`` and ``WatchdogConfig`` from
``repro.train.fault``, numpy only; the elastic restart plan waits for the
multi-card slice.)

``Watchdog``: a NaN/inf loss or gradient blowup triggers a rollback to the
last checkpoint (with an LR backoff option); step-time stall detection
flags slow/hung steps (on a cluster: escalate to the job controller, which
drains the node — the thermal kind of straggle is instead *tuned around* by
the PowerManager).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class WatchdogConfig:
    stall_factor: float = 5.0           # step slower than median x this
    max_rollbacks: int = 3
    lr_backoff: float = 0.5             # multiply LR on rollback
    window: int = 50


class Watchdog:
    """Step-health monitor.  Timing is injected, never defaulted: pass
    ``clock`` (a ``time.monotonic``-shaped callable) at construction, or
    hand ``end_step`` an explicit ``dt`` in simulated seconds.  With
    neither, ``end_step`` raises — a watchdog that silently binds the
    wall clock would make an argless construction nondeterministic
    (train_loop passes ``clock=time.monotonic`` explicitly for real
    runs)."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(), clock=None):
        self.cfg = cfg
        self.clock = clock
        self.step_times: List[float] = []
        self.rollbacks = 0
        self.stalls = 0
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = self.clock() if self.clock is not None else None

    def end_step(self, loss: float, grad_norm: float,
                 dt: Optional[float] = None) -> str:
        """Returns 'ok' | 'stall' | 'rollback'.  ``dt`` overrides the
        measured step duration (simulated time drives the stall check)."""
        if dt is None:
            if self.clock is None:
                raise ValueError(
                    "Watchdog has no clock: pass dt= to end_step or "
                    "construct with clock= (e.g. time.monotonic)")
            dt = self.clock() - (self._t0 or self.clock())
        verdict = "ok"
        if self.step_times:
            med = float(np.median(self.step_times[-self.cfg.window:]))
            if med > 0 and dt > self.cfg.stall_factor * med:
                self.stalls += 1
                verdict = "stall"
        self.step_times.append(dt)
        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            self.rollbacks += 1
            if self.rollbacks > self.cfg.max_rollbacks:
                raise RuntimeError(
                    f"watchdog: {self.rollbacks} rollbacks exceeded budget")
            verdict = "rollback"
        return verdict
