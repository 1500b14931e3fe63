"""Device physics: thermal RC model + DVFS + power-cap governor.

This is the simulated analogue of the paper's §III-B profiling (Fig 5): each
device has its own thermal resistance (cooling quality varies with chassis
placement / manufacturing — paper §VIII-C) so identical workloads produce a
temperature spread; per-device DVFS then throttles the hottest devices into
stragglers.  Power caps act through the same governor the mitigation layer
tunes (paper footnote 2: power capping is more precise than frequency capping).

Units: time s, frequency GHz, power W, temperature °C, work GFLOP.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class DevicePreset:
    """Per-device class constants (MI300X node for paper validation;
    v5e host as the deployment target)."""

    name: str = "mi300x"
    f_max: float = 2.10                   # GHz
    f_min: float = 0.9
    tdp: float = 750.0                    # W
    p_idle: float = 140.0                 # W (β V² f + γΔTV + θV lumped)
    peak_gflops: float = 1_307_000.0      # bf16 dense peak at f_max
    hbm_gbps: float = 5_300.0             # GB/s
    t_amb: float = 32.0                   # °C inlet
    t_throttle: float = 90.0              # °C: hard safety derating onset
    throttle_slope: float = 0.03          # fraction of f_max shed per °C over
    t_ref: float = 40.0                   # °C leakage reference
    leak_quad: float = 1.0e-4             # quadratic leakage: M_eff factor/°C²
    intensity: float = 1.12               # peak-phase power / average (GEMMs)
    r_th_mean: float = 0.064              # °C/W junction->inlet
    r_th_spread: float = 0.10             # relative spread across devices
    tau: float = 25.0                     # s thermal time constant
    m_spread: float = 0.02                # silicon-lottery spread of M = P/f


V5E_PRESET = DevicePreset(
    name="v5e",
    f_max=1.70, f_min=0.8, tdp=250.0, p_idle=55.0,
    peak_gflops=197_000.0, hbm_gbps=819.0,
    t_amb=27.0, t_throttle=88.0, throttle_slope=0.03,
    t_ref=38.0, leak_quad=6.5e-5, intensity=1.10,
    r_th_mean=0.205, r_th_spread=0.10, tau=18.0, m_spread=0.02,
)

MI300X_PRESET = DevicePreset()


def derated_preset(preset: DevicePreset, r_th_factor: float,
                   suffix: str = "-air") -> DevicePreset:
    """A cooling-derated variant of ``preset``: same silicon, worse heat
    path (air-cooled chassis vs liquid, clogged filters, bad slot).  The
    Cooling Matters setup mixes exactly such nodes in one fleet."""
    return dataclasses.replace(preset, name=preset.name + suffix,
                               r_th_mean=preset.r_th_mean * r_th_factor)


MI300X_AIR_PRESET = derated_preset(MI300X_PRESET, 1.22)

PRESETS = {"mi300x": MI300X_PRESET, "v5e": V5E_PRESET,
           "mi300x-air": MI300X_AIR_PRESET}


# --------------------------------------------------------------------------- #
# Cooling churn: degradation over simulated operating time
# --------------------------------------------------------------------------- #
@dataclass
class ChurnEvent:
    """From simulated second ``t`` on, device ``device``'s thermal
    resistance is multiplied by ``factor`` (>1 degrades, <1 is a fan swap /
    filter clean).  Events compose multiplicatively."""

    t: float
    device: int
    factor: float


@dataclass
class ChurnModel:
    """Cooling efficiency drift over simulated time.

    "Not All GPUs Are Created Equal" observes fleets degrading
    heterogeneously over months: dust, fan wear, thermal-paste pump-out.
    ``drift_rate`` applies a uniform fractional r_th growth per simulated
    hour; ``events`` schedule discrete per-device changes, so a straggler
    can *emerge* mid-run and *migrate* (degrade device A, later repair A /
    degrade B harder).
    """

    drift_rate: float = 0.0                 # fractional r_th growth / hour
    events: List[ChurnEvent] = field(default_factory=list)

    def multipliers(self, t: float, n_devices: int) -> np.ndarray:
        m = np.full(n_devices, 1.0 + self.drift_rate * t / 3600.0)
        for ev in self.events:
            if t >= ev.t:
                m[ev.device] *= ev.factor
        return m


@dataclass
class DeviceState:
    temp: np.ndarray                      # (G,) °C
    freq: np.ndarray                      # (G,) GHz
    power: np.ndarray                     # (G,) W (last-interval average)
    cap: np.ndarray                       # (G,) W current power cap


class ThermalModel:
    """Vectorized physics for G devices."""

    def __init__(self, preset: DevicePreset, n_devices: int, seed: int = 0,
                 straggler_boost: float = 1.28,
                 churn: Optional[ChurnModel] = None):
        self.preset = preset
        self.G = n_devices
        self.churn = churn
        self.t_sim = 0.0                 # simulated operating time (churn)
        # fault-injection hook (repro.core.faults via ClusterSim): a
        # callable (G,)-multiplier source composed on top of churn — e.g.
        # thermal_runaway grows a device's r_th without bound.  None keeps
        # the physics bit-identical to a fault-free run.
        self.rth_fault = None
        rng = np.random.default_rng(seed)
        # cooling heterogeneity: smooth spread + one notably worse slot
        # (paper Fig 7 top node: a single persistent straggler; §VIII-C:
        # chassis placement and manufacturing jointly cause straggling)
        spread = rng.normal(0.0, preset.r_th_spread / 2, n_devices)
        spread = np.clip(spread, -preset.r_th_spread, preset.r_th_spread)
        self.r_th = preset.r_th_mean * (1.0 + spread)
        worst = int(rng.integers(n_devices))
        self.r_th[worst] *= straggler_boost
        self.straggler_hint = worst
        # silicon lottery: per-device base power coefficient M0 = P_active/f
        # at T_ref; effective M grows quadratically with temperature (leakage)
        self.m_coef = (0.81 * (preset.tdp - preset.p_idle) / preset.f_max
                       * (1.0 + rng.normal(0.0, preset.m_spread, n_devices)))

    def m_eff(self, temp: np.ndarray) -> np.ndarray:
        """Leakage-adjusted W/GHz: hotter silicon buys fewer GHz per watt."""
        dt = np.maximum(temp - self.preset.t_ref, 0.0)
        return self.m_coef * (1.0 + self.preset.leak_quad * dt * dt)

    def init_state(self) -> DeviceState:
        p = self.preset
        return DeviceState(
            temp=np.full(self.G, p.t_amb + 20.0),
            freq=np.full(self.G, p.f_max),
            power=np.full(self.G, p.p_idle),
            cap=np.full(self.G, p.tdp),
        )

    # ------------------------------------------------------------------ DVFS
    def governor_freq(self, state: DeviceState) -> np.ndarray:
        """f = min(f_max, power-cap limit, hard thermal safety limit).

        The cap limit uses the peak-phase intensity: the governor must keep
        GEMM-phase power under the cap, so sustainable f is set by
        (cap - idle) / (M_eff(T) * intensity) — this is why a hotter device
        under the *same* cap clocks lower (Lit Silicon's root cause) and why
        raising the straggler's cap buys frequency back (the mitigation).
        """
        p = self.preset
        budget = np.maximum(state.cap - p.p_idle, 1.0)
        f_cap = budget / (self.m_eff(state.temp) * p.intensity)
        over = np.maximum(state.temp - p.t_throttle, 0.0)
        f_hard = p.f_max * (1.0 - p.throttle_slope * over)
        return np.clip(np.minimum(f_cap, f_hard), p.f_min, p.f_max)

    def power_draw(self, state: DeviceState, util: np.ndarray) -> np.ndarray:
        """Average draw: waiting at collectives still burns near-peak power
        (the comm kernel keeps the device active) — the GPU-Red opportunity."""
        u_pow = 0.8 + 0.2 * np.clip(util, 0.0, 1.0)
        draw = (self.preset.p_idle
                + self.m_eff(state.temp) * state.freq * u_pow)
        return np.minimum(draw, state.cap)

    def effective_r_th(self) -> np.ndarray:
        """Per-device thermal resistance at the current simulated time —
        the static spread, any churn degradation accrued so far, and any
        injected fault (thermal runaway) multipliers."""
        r = self.r_th
        if self.churn is not None:
            r = r * self.churn.multipliers(self.t_sim, self.G)
        if self.rth_fault is not None:
            r = r * self.rth_fault()
        return r

    def step_thermal(self, state: DeviceState, power: np.ndarray,
                     dt: float) -> None:
        """First-order RC: dT/dt = (T_amb + R*P - T) / tau."""
        p = self.preset
        t_ss = p.t_amb + self.effective_r_th() * power
        a = 1.0 - np.exp(-dt / p.tau)
        state.temp = state.temp + a * (t_ss - state.temp)
        state.power = power

    def update(self, state: DeviceState, util: np.ndarray, dt: float) -> None:
        """One control-interval update: power from current f/util, thermal
        integration, then the governor picks next-interval frequencies."""
        power = self.power_draw(state, util)
        self.step_thermal(state, power, dt)
        state.freq = self.governor_freq(state)
        self.t_sim += dt
