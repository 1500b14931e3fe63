"""The C3 window arithmetic on the card: the port's counterpart of the JAX
package's ``repro.core.jax_engine``.

Two programs, both over the CUDA window-scan kernel
(``kernels/c3_window``, one launch an iteration for every lane):

  * :func:`torch_iteration` — the per-iteration engine behind
    ``engine="torch"`` (``C3Sim.run_iteration``, ``ClusterSim``).  One
    iteration for B barrier groups of G lanes, fed the **same numpy noise
    draws** as the vector engine (``C3Sim._draw_noise``), so its traces are
    the vector engine's up to float rounding.

  * :func:`run_fleet_scan` — the whole-run engine behind Monte-Carlo fleet
    populations: a 30-iteration thermal warmup, then the coupled loop
    (kernel windows, parallelism topology, thermal RC + DVFS governor,
    cooling churn), every per-node quantity a tensor on the device with a
    leading sample axis.  The static thermal lottery comes from
    :func:`build_fleet_arrays` (``ThermalModel``'s numpy streams, exactly);
    the per-iteration noise is the JAX package's: ``jax.random``'s
    threefry2x32 streams are counter-based, so the window scan's draw form
    draws each lane's noise from the sample's ``key`` in the kernel, in
    JAX's layout (:mod:`repro_torch.core.prng` is the plain replay), and
    the port's scan reproduces the JAX package's for the same arrays, up
    to float rounding (``erfinv`` and ``exp`` differ in the last bits
    between XLA and torch on the CPU).  Both are *statistically* equivalent
    to ``ClusterSim``, whose noise is numpy's.

``WindowPlan``, ``window_plan``, ``_step_table``, ``FleetScanSpec``,
``fleet_scan_spec`` and ``build_fleet_arrays`` are copies of the JAX
package's (numpy).  Everything computes in float64 (each tensor names its
dtype; the global default is left alone).  The device is CUDA unless the
caller asks for the CPU, where the kernel's plain version runs; without
CUDA, "cuda" raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.c3_window import ops as c3_ops
from repro_torch.kernels.c3_window.ref import COMM, KERNEL, PULL

__all__ = ["WindowPlan", "window_plan", "torch_iteration", "FleetScanSpec",
           "fleet_scan_spec", "build_fleet_arrays", "run_fleet_scan"]

F64 = torch.float64


def resolve_device(device) -> torch.device:
    """The device asked for; CUDA must exist when asked (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for but CUDA is not "
                           f"available; pass device='cpu' to run the torch "
                           f"engine on the CPU")
    return dev


# --------------------------------------------------------------------------- #
# static window plan (numpy; the JAX package's)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class WindowPlan:
    """The static control flow of one iteration, precomputed per workload.

    Under a global barrier per collective the kernel ranges each collective
    window touches are static: after window ``j``'s arrival phase every lane
    has passed kernel ``max(cprod[:j+1])``, and no lane can pass the first
    kernel gated on a comm ``>= j`` before window ``j`` ends.  Those bounds
    give, per window, a closed kernel range for the full-rate arrival
    advance and the slowed window advance, so the whole iteration unrolls
    into ~``Kc + sum(window spans)`` steps with no data-dependent loops.
    Within those ranges every comm gate is provably open and non-binding,
    so the steps need no gate arithmetic; gate graphs that could deadlock
    are rejected while building the plan.  Hashable (all-tuple)."""

    n_comp: int                               # Kc
    n_comm: int                               # Km
    cprod: Tuple[int, ...]                    # (Km,) producer kernel or -1
    k_wait: Tuple[int, ...]                   # (Kc,) gating comm or -1
    arrival: Tuple[Tuple[int, int], ...]      # (Km,) [lo, hi) full-rate range
    window: Tuple[Tuple[int, int], ...]       # (Km,) [lo, hi) slowed range
    drain_lo: int                             # first kernel of the drain

    @property
    def n_steps(self) -> int:
        """Total kernel-steps of the unrolled iteration."""
        spans = sum(hi - lo for lo, hi in self.arrival)
        spans += sum(hi - lo for lo, hi in self.window)
        return spans + (self.n_comp - self.drain_lo)


def window_plan(wl) -> WindowPlan:
    """Build (and cache on the workload) the static window plan."""
    cached = getattr(wl, "_c3_torch_plan", None)
    if cached is not None:
        return cached
    from repro_torch.core.c3sim import workload_arrays
    A = workload_arrays(wl)
    k_wait = tuple(int(x) for x in A["wait"])
    cprod = tuple(int(x) for x in A["cprod"])
    Kc, Km = len(k_wait), len(cprod)
    # first kernel gated on comm >= j, per window j
    first_gated = []
    for j in range(Km):
        idx = [i for i, w in enumerate(k_wait) if w >= j]
        first_gated.append(min(idx) if idx else Kc)
    arrival: List[Tuple[int, int]] = []
    window: List[Tuple[int, int]] = []
    maxprod = -1
    for j in range(Km):
        prod = cprod[j]
        if prod >= 0:
            lo = maxprod + 1
            for i in range(lo, prod + 1):
                if k_wait[i] >= j:
                    raise RuntimeError(
                        f"C3Sim[torch]: deadlock — kernel {i} (producer path "
                        f"of comm {j}) is gated on comm {k_wait[i]}, which "
                        f"cannot have ended")
            arrival.append((lo, prod + 1))
            maxprod = max(maxprod, prod)
        else:
            arrival.append((0, 0))
        window.append((maxprod + 1, max(maxprod + 1, first_gated[j])))
    plan = WindowPlan(n_comp=Kc, n_comm=Km, cprod=cprod, k_wait=k_wait,
                      arrival=tuple(arrival), window=tuple(window),
                      drain_lo=maxprod + 1)
    wl._c3_torch_plan = plan
    return plan


@functools.lru_cache(maxsize=64)
def _step_table(plan: WindowPlan):
    """Flatten the window plan into (kind, idx, capped) per scan step.  The
    kinds (``kernels/c3_window/ref.py``): KERNEL advances kernel idx
    (capped: slowed toward the barrier), COMM resolves comm idx (arrival,
    global end, the new barrier), PULL pulls every lane's clock to the
    barrier (the window's end).

    Lane clocks start each window at the previous barrier, so the
    arrival-phase ``need`` mask is the plain cursor match, and the arrival
    value is the lane's clock at the comm step."""
    kinds: List[int] = []
    idx: List[int] = []
    capped: List[bool] = []

    def emit(kind, i, c=False):
        kinds.append(kind)
        idx.append(i)
        capped.append(c)

    for j in range(plan.n_comm):
        lo, hi = plan.arrival[j]
        for i in range(lo, hi):
            emit(KERNEL, i)
        emit(COMM, j)
        lo, hi = plan.window[j]
        for i in range(lo, hi):
            emit(KERNEL, i, c=True)
        emit(PULL, 0)
    for i in range(plan.drain_lo, plan.n_comp):
        emit(KERNEL, i)
    return (np.asarray(kinds, np.int32), np.asarray(idx, np.int32),
            np.asarray(capped))


@functools.lru_cache(maxsize=64)
def _table(plan: WindowPlan, device: str) -> torch.Tensor:
    """The step table as the kernel reads it: (n_steps, 3) int32."""
    kinds, idx, capped = _step_table(plan)
    t = np.stack([kinds, idx, capped.astype(np.int32)], axis=1)
    return torch.as_tensor(t, dtype=torch.int32, device=device)


# --------------------------------------------------------------------------- #
# one iteration for B barrier groups, from the vector engine's numpy noise
# --------------------------------------------------------------------------- #
def torch_iteration(sims: Sequence, freqs: Sequence[np.ndarray],
                    noises: Sequence[tuple], device="cuda") -> List:
    """Run one iteration for B node-groups in one launch of the window
    scan on ``device``.

    :func:`repro_torch.core.c3sim.vector_iteration`'s contract: every sim
    shares one Workload, presets and frequencies may differ per group, comm
    barriers are per group, and ``noises`` carries each sim's own
    ``_draw_noise()`` output, so per-node numpy RNG streams stay those of a
    per-node run.  Returns the per-group `IterationTrace`s."""
    dev = resolve_device(device)
    wl = sims[0].wl
    A = sims[0].arrays
    cfg = sims[0].cfg
    for s in sims[1:]:
        if s.arrays is not A:
            raise ValueError("torch_iteration: all sims must share one "
                             "Workload (kernel schedules must be identical)")
    plan = window_plan(wl)
    B, G = len(sims), sims[0].G
    Kc, Km = plan.n_comp, plan.n_comm

    rate_f = np.empty((B, G))
    rm = np.empty(B)
    for b, (s, f) in enumerate(zip(sims, freqs)):
        p = s.preset
        rate_f[b] = p.peak_gflops * cfg.gemm_eff * (np.asarray(f) / p.f_max)
        rm[b] = p.hbm_gbps
    noise_c = np.stack([n for n, _ in noises])       # (B, G, Kc)
    dur_comm = np.stack([d for _, d in noises])      # (B, Km)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=F64, device=dev)
    rate_f, rm = put(rate_f.reshape(-1)), put(rm)
    out = c3_ops.c3_window(
        _table(plan, str(dev)), rate_f, rate_f / (1.0 + cfg.kappa_comp), rm,
        rm / (1.0 + cfg.kappa_mem),
        put(noise_c.reshape(B * G, Kc).T[None]), put(A["gflop"]),
        put(A["gbyte"]), put(dur_comm.reshape(B, Km)), G, emit=True)
    comp_start, comp_end, comp_ovl, comm_lstart, comm_gend, busy = (
        x.cpu().numpy() for x in out)

    def lanes(x):                     # (K, B G) -> (B, G, K)
        return np.ascontiguousarray(x.T.reshape(B, G, -1))
    comp_start, comp_end, comp_ovl, comm_lstart = (
        lanes(x) for x in (comp_start, comp_end, comp_ovl, comm_lstart))
    busy = busy.reshape(B, G)
    return [sims[b]._make_trace(comp_start[b], comp_end[b], comp_ovl[b],
                                comm_lstart[b], comm_gend[b], busy[b])
            for b in range(B)]


# --------------------------------------------------------------------------- #
# whole-run fleet scan: iterations × thermal × churn × topology on the card
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FleetScanSpec:
    """The static half of a fleet scan (the JAX package's): everything that
    changes shapes or control flow; everything numeric rides in the
    `build_fleet_arrays` dict, stacked along a leading sample axis for a
    population."""

    plan: WindowPlan
    n_nodes: int
    n_devices: int
    iterations: int
    warmup: int = 30                    # NodeSim's thermal warm-up length
    topology: str = "dp"                # dp | pp | tp
    microbatches: int = 8               # pp
    tp_syncs: int = 16                  # tp
    spike: bool = False                 # comm latency spikes enabled
    collect: str = "full"               # "full": (T, N) series | "summary"


_NODE_FIELDS = ("f_max", "f_min", "p_idle", "peak_gflops", "hbm_gbps",
                "t_amb", "t_throttle", "throttle_slope", "t_ref",
                "leak_quad", "intensity", "tau")


def fleet_scan_spec(workload, sim_cfg, cluster_cfg, iterations: int,
                    collect: str = "full",
                    devices_per_node: int = 8) -> FleetScanSpec:
    """The static companion of `build_fleet_arrays` for one scenario."""
    from repro_torch.core.topology import make_topology
    cc = cluster_cfg
    if cc.topology not in ("dp", "pp", "tp"):
        raise ValueError(f"unsupported scan topology {cc.topology!r}")
    topo = make_topology(cc, cc.n_nodes, workload, 1.0, seed=0)
    return FleetScanSpec(
        plan=window_plan(workload), n_nodes=cc.n_nodes,
        n_devices=devices_per_node, iterations=int(iterations),
        topology=cc.topology, microbatches=cc.microbatches,
        tp_syncs=int(getattr(topo, "K", 1)),
        spike=bool(sim_cfg.comm_spike_p > 0), collect=collect)


def build_fleet_arrays(workload, preset, sim_cfg, cluster_cfg,
                       caps_w: Optional[float], seed: int,
                       devices_per_node: int = 8,
                       rng_seed: int = 0) -> Dict[str, np.ndarray]:
    """The numeric half of a fleet scan: per-lane thermal lottery, per-node
    preset constants, churn event tables, topology constants, PRNG key.

    The thermal draws (``r_th`` spread + straggler slot, silicon-lottery
    ``m_coef``) reproduce ``ThermalModel``'s numpy streams exactly (node
    ``n`` draws from ``default_rng(seed + 7919 * n)`` through an actual
    `ThermalModel`), so a scan shares ClusterSim's static physics; only the
    per-iteration noise streams differ (JAX's threefry2x32 streams from
    ``key``, drawn from ``rng_seed``).  For a population build one dict per
    sample and stack every entry along a new leading axis."""
    from repro_torch.core.c3sim import workload_arrays
    from repro_torch.core.thermal import PRESETS, ThermalModel
    from repro_torch.core.topology import make_topology

    cc = cluster_cfg
    N, G = cc.n_nodes, devices_per_node
    if cc.node_presets is not None:
        if len(cc.node_presets) != N:
            raise ValueError(f"node_presets has {len(cc.node_presets)} "
                             f"entries for {N} nodes")
        presets = [PRESETS[p] if isinstance(p, str) else p
                   for p in cc.node_presets]
    else:
        presets = [preset] * N

    arrays: Dict[str, np.ndarray] = {}
    r_th = np.empty((N, G))
    m_coef = np.empty((N, G))
    per_node = {f: np.empty(N) for f in _NODE_FIELDS}
    churn = cc.churn or {}
    max_ev = max([len(cm.events) for cm in churn.values()] + [1])
    drift_rate = np.zeros(N)
    ev_t = np.full((N, max_ev), np.inf)
    ev_dev = np.zeros((N, max_ev), np.int32)
    ev_factor = np.ones((N, max_ev))
    for n in range(N):
        boost = (cc.straggler_boost if n == cc.straggler_node
                 else cc.healthy_boost)
        tm = ThermalModel(presets[n], G, seed=seed + 7919 * n,
                          straggler_boost=boost, churn=None)
        r_th[n] = tm.r_th
        m_coef[n] = tm.m_coef
        for f in _NODE_FIELDS:
            per_node[f][n] = getattr(presets[n], f)
        cm = churn.get(n)
        if cm is not None:
            drift_rate[n] = cm.drift_rate
            for e, ev in enumerate(cm.events):
                ev_t[n, e] = ev.t
                ev_dev[n, e] = ev.device
                ev_factor[n, e] = ev.factor
    arrays["r_th"] = r_th
    arrays["m_coef"] = m_coef
    arrays.update(per_node)
    arrays["drift_rate"] = drift_rate
    arrays["ev_t"] = ev_t
    arrays["ev_dev"] = ev_dev
    arrays["ev_factor"] = ev_factor
    tdp = np.array([p.tdp for p in presets])
    arrays["tdp_caps"] = np.repeat(tdp[:, None], G, axis=1)
    arrays["caps"] = (np.full((N, G), float(caps_w))
                      if caps_w is not None else arrays["tdp_caps"].copy())

    A = workload_arrays(workload)
    arrays["gflop"] = A["gflop"]
    arrays["gbyte"] = A["gbyte"]
    arrays["cbytes"] = A["cbytes"]

    grad = cc.grad_bytes
    if grad is None:
        grad = sum(c.bytes for c in workload.comm
                   if c.name.startswith("rs_"))
        if grad <= 0:
            grad = workload.total_bytes / 3.0
    topo = make_topology(cc, N, workload, float(grad), seed=seed)
    arrays["comm_const"] = np.asarray(topo.comm_time(), float)
    arrays["tp_jitter"] = np.asarray(getattr(topo, "jitter", 0.0), float)
    arrays["tp_skew_cost"] = np.asarray(
        getattr(topo, "skew_cost", 0.0), float)
    for f in ("kappa_comp", "kappa_mem", "gemm_eff", "comm_gbps", "noise",
              "comm_spike_p", "comm_spike_mult"):
        arrays[f] = np.asarray(getattr(sim_cfg, f), float)
    arrays["key"] = np.asarray(
        np.random.default_rng(rng_seed).integers(0, 2 ** 32, size=2),
        np.uint32)
    return arrays


def _fleet_scan(spec: FleetScanSpec, a: Dict[str, torch.Tensor],
                keys: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The scan: warmup (uncoupled, TDP caps) then the coupled loop, for S
    samples at once.  ``a`` holds the `build_fleet_arrays` entries as
    tensors with a leading sample axis: per-node fields (S, N), per-lane
    (S, N, G), scalars (S,); ``keys`` (S, 2) int32 the samples' raw keys.
    Sample s draws what ``_fleet_scan_core`` draws from its key: iteration
    i's noise from ``fold_in(key, i)`` in the warmup and ``fold_in(key,
    warmup + 1 + i)`` in the main loop (the draw form of the window scan
    draws it), the TP jitter from ``fold_in(key, 2**20 + i)``
    (``jax_normal``)."""
    plan = spec.plan
    N, G = spec.n_nodes, spec.n_devices
    S = keys.shape[0]
    dev = a["r_th"].device
    if not all(torch.equal(a[k], a[k][:1].expand_as(a[k]))
               for k in ("gflop", "gbyte")):
        raise ValueError("run_fleet_scan: the samples' workloads differ; "
                         "one scan runs one workload")
    table = _table(plan, str(dev))
    gflop, gbyte = a["gflop"][0].contiguous(), a["gbyte"][0].contiguous()

    def per_sample(k):                  # (S,) -> (S, 1, 1)
        return a[k].view(S, 1, 1)

    def per_node(k):                    # (S, N) -> (S, N, 1)
        return a[k][:, :, None]

    base = (a["cbytes"] / (a["comm_gbps"][:, None] * 1e9)).contiguous()
    sigma, spike_p, spike_mult = (a[k].contiguous() for k in (
        "noise", "comm_spike_p", "comm_spike_mult"))

    def run_iteration(freq, datum):
        rate_f = (per_node("peak_gflops") * per_sample("gemm_eff")
                  * freq / per_node("f_max"))
        rate_f_s = rate_f / (1.0 + per_sample("kappa_comp"))
        rm = a["hbm_gbps"]
        rm_s = rm / (1.0 + a["kappa_mem"][:, None])
        t_iter, util = c3_ops.c3_window_draw(
            table, rate_f.reshape(-1), rate_f_s.reshape(-1), rm.reshape(-1),
            rm_s.reshape(-1), keys, datum, sigma, base, spike_p, spike_mult,
            spec.spike, gflop, gbyte, G)
        return t_iter.view(S, N), util.view(S, N, G)

    def m_eff(temp):
        dt = torch.clamp_min(temp - per_node("t_ref"), 0.0)
        return a["m_coef"] * (1.0 + per_node("leak_quad") * dt * dt)

    lanes = torch.arange(G, device=dev)

    def effective_r_th(t_sim):
        drift = 1.0 + per_node("drift_rate") * t_sim[:, :, None] / 3600.0
        active = torch.where(t_sim[:, :, None] >= a["ev_t"], a["ev_factor"],
                             1.0)
        onehot = a["ev_dev"][:, :, :, None] == lanes
        ev = torch.prod(torch.where(onehot, active[:, :, :, None], 1.0),
                        dim=2)
        return a["r_th"] * drift * ev

    def topology_step(t_local, i):
        if spec.topology == "dp":
            t_max = t_local.amax(1)
            return t_max + a["comm_const"], t_max[:, None] - t_local
        if spec.topology == "pp":
            tau = t_local / spec.microbatches
            t_fleet = (tau.sum(1) + (spec.microbatches - 1) * tau.amax(1)
                       + a["comm_const"])
            return t_fleet, t_fleet[:, None] - t_local
        w = c3_ops.jax_normal(keys, 2 ** 20 + i, N * spec.tp_syncs)
        w = torch.exp(w.view(S, N, spec.tp_syncs) * per_sample("tp_jitter"))
        w = w / w.sum(2, keepdim=True)
        seg = t_local[:, :, None] * w
        seg_max = seg.amax(1)                       # (S, K)
        t_skew = (a["tp_skew_cost"] * (seg_max - seg.amin(1)).sum(1)
                  if N > 1 else 0.0)
        t_fleet = seg_max.sum(1) + t_skew + a["comm_const"]
        return t_fleet, (seg_max[:, None, :] - seg).sum(2)

    def commit(temp, freq, cap, t_sim, util, t_interval):
        """`ThermalModel.update` over (S, N, G) lanes: power from current
        freq/util, RC thermal step, then the governor picks next-interval
        frequencies from the new temperature."""
        u_pow = 0.8 + 0.2 * torch.clamp(util, 0.0, 1.0)
        draw = per_node("p_idle") + m_eff(temp) * freq * u_pow
        power = torch.minimum(draw, cap)
        t_ss = per_node("t_amb") + effective_r_th(t_sim) * power
        alpha = 1.0 - torch.exp(-t_interval[:, :, None] / per_node("tau"))
        temp = temp + alpha * (t_ss - temp)
        budget = torch.clamp_min(cap - per_node("p_idle"), 1.0)
        f_cap = budget / (m_eff(temp) * per_node("intensity"))
        over = torch.clamp_min(temp - per_node("t_throttle"), 0.0)
        f_hard = per_node("f_max") * (1.0 - per_node("throttle_slope") * over)
        freq = torch.minimum(torch.maximum(torch.minimum(f_cap, f_hard),
                                           per_node("f_min")),
                             per_node("f_max"))
        return temp, freq, power, t_sim + t_interval

    zeros = torch.zeros((S, N, G), dtype=F64, device=dev)
    temp = per_node("t_amb") + 20.0 + zeros
    freq = per_node("f_max") + zeros
    t_sim = torch.zeros((S, N), dtype=F64, device=dev)
    for i in range(spec.warmup):
        t_local, util = run_iteration(freq, i)
        temp, freq, _, t_sim = commit(temp, freq, a["tdp_caps"], t_sim,
                                      util, t_local)
    t_sim = torch.zeros((S, N), dtype=F64, device=dev)  # churn clock resets

    series: List[tuple] = []
    for i in range(spec.iterations):
        t_local, util = run_iteration(freq, spec.warmup + 1 + i)
        t_fleet, lead = topology_step(t_local, i)
        if spec.topology == "tp":       # active wait: hot inside collectives
            util_eff = (util * t_local[:, :, None]
                        + (t_fleet[:, None] - t_local)[:, :, None]
                        ) / t_fleet[:, None, None]
        else:                           # barrier/bubble wait: idle and cool
            util_eff = util * (t_local / t_fleet[:, None])[:, :, None]
        temp, freq, power, t_sim = commit(
            temp, freq, a["caps"], t_sim, util_eff,
            t_fleet[:, None].expand(S, N))
        node_power = power.sum(2)
        if spec.collect == "full":
            series.append((t_fleet, t_local, lead, node_power))
        else:
            series.append((t_fleet, lead.amax(1), t_local.argmax(1),
                           lead.argmin(1), node_power.sum(1)))
    cols = [torch.stack(c, dim=1) for c in zip(*series)]
    names = (("t_fleet", "t_local", "lead", "node_power")
             if spec.collect == "full" else
             ("t_fleet", "lead_max", "slowest_node", "straggler_node",
              "fleet_power"))
    return {**dict(zip(names, cols)), "temp": temp, "freq": freq}


def run_fleet_scan(spec: FleetScanSpec, arrays: Dict[str, np.ndarray],
                   device="cuda") -> Dict[str, np.ndarray]:
    """Execute one fleet run or, when every array carries a leading sample
    axis (``r_th`` (S, N, G)), a population of runs, on ``device``.

    Returns, as numpy arrays under the JAX package's keys, per-iteration
    series (``t_fleet`` plus, per ``spec.collect``, full (T, N)
    ``t_local``/``lead``/``node_power`` series or per-iteration summary
    scalars) and the final thermal ``temp``/``freq`` state, each with the
    leading sample axis when the arrays had one."""
    dev = resolve_device(device)
    batched = np.ndim(arrays["r_th"]) == 3
    lead = (lambda x: x) if batched else (lambda x: x[None])
    keys = np.ascontiguousarray(lead(np.asarray(arrays["key"], np.uint32))
                                .reshape(-1, 2))
    a = {k: torch.as_tensor(lead(np.asarray(v)), device=dev)
         for k, v in arrays.items() if k != "key"}
    out = _fleet_scan(spec, a, torch.as_tensor(keys.view(np.int32),
                                               device=dev))
    return {k: (v if batched else v[0]).cpu().numpy()
            for k, v in out.items()}
