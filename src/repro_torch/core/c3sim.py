"""Two-stream discrete-event node simulator: the Lit Silicon coupling engine.

Per device: a *compute stream* (ordered kernels, rate ∝ frequency for
FLOP-bound work, frequency-independent for HBM-bound work) and a *comm
stream* (ordered collectives).  Collectives are synchronization points: a
device's collective occupies its comm stream from its *local* arrival until
the *global* completion (leaders arrive early and wait — their comm kernels
stretch).  While the comm stream is busy, compute on that device is slowed by
the contention factor κ (paper §II-B: up to 40 %, avg 18.9 % kernel slowdown
under C3).  These two rules alone generate the paper's dynamics:

  ① identical start → ② leads grow on constant-overlap kernels →
  ③ leaders wait at collectives, overlap ↑, contention slows them,
    equilibrium → ④ leaders idle at the iteration barrier.

The simulator emits per-kernel (start, end, overlap) traces — the exact
interface Algorithm 1 consumes, and the same record a TPU profiler hook
would produce on real hardware.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.thermal import ChurnModel, DevicePreset, DeviceState, ThermalModel
from repro_torch.core.workload import Workload


@dataclass
class SimConfig:
    """Knobs of the C3 (concurrent-execution coupling) iteration model:
    contention factors, link rates, stochastic jitter, and which engine
    executes the window arithmetic (docs/engines.md)."""

    kappa_comp: float = 0.45        # compute slowdown factor while comm busy
    kappa_mem: float = 0.75         # memory-bound slowdown while comm busy
    gemm_eff: float = 0.45          # fraction of peak for GEMM kernels
    comm_gbps: float = 62.0         # per-device effective collective GB/s
    comm_spike_p: float = 0.0       # probability of a latency spike per comm
    comm_spike_mult: float = 8.0    # spike multiplier (paper Fig 16 MoE)
    noise: float = 0.008            # per-kernel duration noise (lognormal σ)
    seed: int = 0
    engine: str = "event"           # "event" (heap reference) | "batched"
    #                                 | "vector" (numpy, batches node groups)
    #                                 | "torch" (the CUDA window scan; see
    #                                 torch_engine)
    device: str = "cuda"            # where engine "torch" runs (no other
    #                                 engine reads it); "cpu" when asked


def workload_arrays(wl: Workload) -> dict:
    """Vectorized kernel tables + producer/gate maps, cached on the Workload.

    Building these per C3Sim instance is wasteful once a cluster holds N
    nodes over the same workload; the cache keys on the Workload object so
    every C3Sim sharing it reuses one set of arrays.
    """
    cached = getattr(wl, "_c3_arrays", None)
    if cached is not None:
        return cached
    producers: Dict[int, List[int]] = {}
    for j, ck in enumerate(wl.comm):
        if ck.producer is not None:
            producers.setdefault(ck.producer, []).append(j)
    comm_gates: Dict[int, List[int]] = {}
    for i, k in enumerate(wl.comp):
        if k.wait_comm is not None:
            comm_gates.setdefault(k.wait_comm, []).append(i)
    arrays = {
        "gflop": np.array([k.gflop for k in wl.comp], float),
        "gbyte": np.array([k.gbyte for k in wl.comp], float),
        "wait": np.array([-1 if k.wait_comm is None else k.wait_comm
                          for k in wl.comp], int),
        "cbytes": np.array([c.bytes for c in wl.comm], float),
        "cprod": np.array([-1 if c.producer is None else c.producer
                           for c in wl.comm], int),
        "producers": producers,
        "comm_gates": comm_gates,
        "comp_names": [k.name for k in wl.comp],
        "comm_names": [c.name for c in wl.comm],
    }
    wl._c3_arrays = arrays
    return arrays


@dataclass
class IterationTrace:
    """Per-iteration telemetry: the Algorithm-1 input format."""

    comp_names: List[str]
    comm_names: List[str]
    comp_start: np.ndarray          # (G, Kc) s
    comp_end: np.ndarray            # (G, Kc)
    comp_overlap: np.ndarray        # (G, Kc) seconds overlapped with comm
    comm_start: np.ndarray          # (G, Km) local starts
    comm_end: np.ndarray            # (Km,) global ends
    t_iter: float
    util: np.ndarray                # (G,) compute busy fraction

    @property
    def comp_dur(self) -> np.ndarray:
        return self.comp_end - self.comp_start

    @property
    def overlap_ratio(self) -> np.ndarray:
        return self.comp_overlap / np.maximum(self.comp_dur, 1e-12)

    @property
    def comm_dur(self) -> np.ndarray:
        return self.comm_end[None, :] - self.comm_start


class C3Sim:
    """Event-driven execution of one Workload iteration on G devices."""

    def __init__(self, workload: Workload, preset: DevicePreset,
                 sim_cfg: SimConfig, n_devices: int):
        self.wl = workload
        self.preset = preset
        self.cfg = sim_cfg
        self.G = n_devices
        self.rng = np.random.default_rng(sim_cfg.seed + 104729)
        self.arrays = workload_arrays(workload)
        # comm waiters: comp index -> list of comm indices it produces
        self.producers: Dict[int, List[int]] = self.arrays["producers"]
        # comp waiters: comm index -> list of comp indices gated on it
        self.comm_gates: Dict[int, List[int]] = self.arrays["comm_gates"]

    # ---------------------------------------------------------------- noise
    def _draw_noise(self):
        """Per-iteration stochastic draws, shared by both engines so the
        same seed consumes the same RNG stream regardless of engine."""
        cfg, G = self.cfg, self.G
        Kc, Km = len(self.wl.comp), len(self.wl.comm)
        noise_c = np.exp(self.rng.normal(0, cfg.noise, (G, Kc)))
        base = self.arrays["cbytes"] / (cfg.comm_gbps * 1e9)
        if not cfg.comm_spike_p:
            dur_comm = base * np.exp(self.rng.normal(0, cfg.noise, Km))
        else:
            dur_comm = np.empty(Km)
            for j in range(Km):
                d = base[j]
                if self.rng.random() < cfg.comm_spike_p:
                    d *= cfg.comm_spike_mult * (1 + self.rng.random())
                dur_comm[j] = d * np.exp(self.rng.normal(0, cfg.noise))
        return noise_c, dur_comm

    # ------------------------------------------------------------------ run
    def run_iteration(self, freq: np.ndarray,
                      engine: Optional[str] = None) -> IterationTrace:
        """Execute one iteration at per-device frequencies ``freq`` (G,)
        and return its `IterationTrace`.

        The engine entry point: ``engine`` (default ``cfg.engine``) picks
        the execution strategy — ``"event"`` (heap reference),
        ``"batched"`` (per-window numpy), ``"vector"`` / ``"torch"``
        (all-lanes batched; this sim becomes a single-group call; "torch"
        on ``cfg.device``).  All
        engines consume the same RNG draws (`_draw_noise` runs first), so
        the choice never changes the physics — see docs/engines.md for the
        per-pair equivalence guarantees."""
        engine = engine or self.cfg.engine
        noise_c, dur_comm = self._draw_noise()
        if engine == "batched":
            return self._run_batched(freq, noise_c, dur_comm)
        if engine == "event":
            return self._run_event(freq, noise_c, dur_comm)
        if engine == "vector":
            return vector_iteration([self], [np.asarray(freq, float)],
                                    [(noise_c, dur_comm)])[0]
        if engine == "torch":
            from repro_torch.core.torch_engine import torch_iteration
            return torch_iteration([self], [np.asarray(freq, float)],
                                   [(noise_c, dur_comm)],
                                   device=self.cfg.device)[0]
        if engine == "jax":
            raise ValueError("engine 'jax' is the JAX package's; the port's "
                             "counterpart is engine 'torch'")
        raise ValueError(f"unknown engine {engine!r}")

    # ----------------------------------------------------- event (reference)
    def _run_event(self, freq: np.ndarray, noise_c: np.ndarray,
                   dur_comm: np.ndarray) -> IterationTrace:
        wl, G, cfg, p = self.wl, self.G, self.cfg, self.preset
        Kc, Km = len(wl.comp), len(wl.comm)
        comp_rate_f = p.peak_gflops * cfg.gemm_eff * (freq / p.f_max)  # GF/s
        mem_rate = p.hbm_gbps                                          # GB/s

        comp_start = np.full((G, Kc), np.nan)
        comp_end = np.full((G, Kc), np.nan)
        comp_ovl = np.zeros((G, Kc))
        comm_lstart = np.full((G, Km), np.nan)
        comm_gend = np.full(Km, np.nan)
        busy_time = np.zeros(G)

        # per-device runtime state
        ci = np.zeros(G, int)               # current compute kernel
        gf_rem = np.zeros(G)
        gb_rem = np.zeros(G)
        t_upd = np.zeros(G)
        comm_busy = np.zeros(G, bool)
        blocked = np.zeros(G, bool)         # compute gated on a comm kernel
        cj = 0                              # global comm cursor
        arrived = np.zeros(G, bool)
        comm_active = False                 # current collective in flight
        seqs = np.zeros(G, int)             # event staleness counters

        heap: list = []
        ctr = 0

        def rates(g):
            if comm_busy[g]:
                return (comp_rate_f[g] / (1 + cfg.kappa_comp),
                        mem_rate / (1 + cfg.kappa_mem))
            return comp_rate_f[g], mem_rate

        def load_kernel(g, t):
            """Load compute kernel ci[g]; returns False if stream done."""
            i = ci[g]
            if i >= Kc:
                return False
            k = wl.comp[i]
            if k.wait_comm is not None and not np.isfinite(
                    comm_gend[k.wait_comm]) :
                blocked[g] = True
                return False
            if k.wait_comm is not None and comm_gend[k.wait_comm] > t:
                blocked[g] = True
                return False
            gf_rem[g] = k.gflop * noise_c[g, i]
            gb_rem[g] = k.gbyte * noise_c[g, i]
            comp_start[g, i] = t
            t_upd[g] = t
            push_done(g, t)
            return True

        def push_done(g, t):
            nonlocal ctr
            rf, rm = rates(g)
            dt = gf_rem[g] / rf + gb_rem[g] / rm
            seqs[g] += 1
            ctr += 1
            heapq.heappush(heap, (t + dt, ctr, "cdone", g, seqs[g]))

        def advance(g, t):
            """Account progress of g's current kernel up to time t."""
            if ci[g] >= Kc or blocked[g] or np.isnan(comp_start[g, ci[g]]) \
                    or not np.isnan(comp_end[g, ci[g]]):
                t_upd[g] = t
                return
            dt = t - t_upd[g]
            if dt <= 0:
                return
            rf, rm = rates(g)
            if comm_busy[g]:
                comp_ovl[g, ci[g]] += dt
            # gflop portion first, then gbyte portion
            use = min(dt, gf_rem[g] / rf if rf > 0 else np.inf)
            gf_rem[g] -= use * rf
            rem_dt = dt - use
            gb_rem[g] = max(0.0, gb_rem[g] - rem_dt * rm)
            t_upd[g] = t

        def try_arrive(g, t):
            """Device g tries to arrive at the current collective cj."""
            nonlocal comm_active, ctr
            if cj >= Km or arrived[g] or comm_active:
                pass
            if cj >= Km or arrived[g]:
                return
            ck = wl.comm[cj]
            if ck.producer is not None and (
                    np.isnan(comp_end[g, ck.producer])):
                return
            arrived[g] = True
            comm_lstart[g, cj] = t
            advance(g, t)
            comm_busy[g] = True
            if ci[g] < Kc and not blocked[g]:
                push_done(g, t)
            if arrived.all():
                comm_active = True
                ctr += 1
                heapq.heappush(heap, (t + dur_comm[cj], ctr, "gend", cj, 0))

        def finish_kernel(g, t):
            nonlocal ctr
            i = ci[g]
            comp_end[g, i] = t
            busy_time[g] += comp_end[g, i] - comp_start[g, i]
            # producers: comm kernels waiting on this compute
            for j in self.producers.get(i, ()):
                if j == cj:
                    try_arrive(g, t)
            ci[g] += 1
            if load_kernel(g, t):
                pass
            # a newly loaded (or blocked) kernel might also be a producer edge
            if cj < Km:
                try_arrive(g, t)

        # ---- bootstrap ------------------------------------------------------
        for g in range(G):
            load_kernel(g, 0.0)
        for g in range(G):
            try_arrive(g, 0.0)

        # ---- event loop -----------------------------------------------------
        guard = 0
        while heap:
            guard += 1
            if guard > 5_000_000:
                raise RuntimeError("C3Sim: event budget exceeded (deadlock?)")
            t, _, kind, a, s = heapq.heappop(heap)
            if kind == "cdone":
                g = a
                if s != seqs[g] or ci[g] >= Kc or blocked[g]:
                    continue
                advance(g, t)
                if gf_rem[g] > 1e-9 or gb_rem[g] > 1e-9:
                    push_done(g, t)          # rate changed mid-flight
                    continue
                finish_kernel(g, t)
            elif kind == "gend":
                j = a
                comm_gend[j] = t
                comm_active = False
                arrived[:] = False
                for g in range(G):
                    advance(g, t)
                    comm_busy[g] = False
                # unblock compute kernels gated on j
                for g in range(G):
                    if blocked[g] and ci[g] < Kc:
                        k = wl.comp[ci[g]]
                        if k.wait_comm == j:
                            blocked[g] = False
                            load_kernel(g, t)
                    elif ci[g] < Kc and not np.isnan(comp_start[g, ci[g]]) \
                            and np.isnan(comp_end[g, ci[g]]):
                        push_done(g, t)      # rate changed: reschedule
                cj += 1
                if cj < Km:
                    for g in range(G):
                        try_arrive(g, t)

        return self._make_trace(comp_start, comp_end, comp_ovl,
                                comm_lstart, comm_gend, busy_time)

    def _make_trace(self, comp_start, comp_end, comp_ovl, comm_lstart,
                    comm_gend, busy_time) -> IterationTrace:
        """Shared trace assembly — both engines must produce the identical
        record (property-tested), so it lives in exactly one place."""
        t_iter = float(np.nanmax(comp_end))
        if comm_gend.size:
            t_iter = max(t_iter, float(np.nanmax(comm_gend)))
        return IterationTrace(
            comp_names=list(self.arrays["comp_names"]),
            comm_names=list(self.arrays["comm_names"]),
            comp_start=comp_start, comp_end=comp_end, comp_overlap=comp_ovl,
            comm_start=comm_lstart, comm_end=comm_gend,
            t_iter=t_iter, util=np.asarray(busy_time) / max(t_iter, 1e-12))

    # ------------------------------------------------------- batched engine
    def _run_batched(self, freq: np.ndarray, noise_c: np.ndarray,
                     dur_comm: np.ndarray) -> IterationTrace:
        """Fast path: exploit that collectives are processed strictly in
        order with a global barrier each — so the iteration decomposes into
        one window per collective.  Per window: (1) advance each device at
        full rate until its producer kernel completes (= its local arrival),
        (2) the global end is max(arrival) + duration, (3) advance each
        device slowed from its arrival to the global end.  No event heap,
        no re-push churn; kernel work tables are precomputed numpy arrays.
        Produces the same trace as the event engine (same RNG stream, same
        piecewise-rate integration at the same boundaries)."""
        wl, G, cfg, p = self.wl, self.G, self.cfg, self.preset
        A = self.arrays
        Kc, Km = len(wl.comp), len(wl.comm)
        k_wait = A["wait"].tolist()
        cprod = A["cprod"].tolist()
        rate_f = (p.peak_gflops * cfg.gemm_eff * (freq / p.f_max)).tolist()
        rate_f_s = [r / (1 + cfg.kappa_comp) for r in rate_f]
        rm, rm_s = p.hbm_gbps, p.hbm_gbps / (1 + cfg.kappa_mem)
        work_f = (A["gflop"][None, :] * noise_c).tolist()   # (G, Kc)
        work_b = (A["gbyte"][None, :] * noise_c).tolist()
        dur_comm_l = dur_comm.tolist()
        nan = float("nan")
        inf = float("inf")

        # hot-loop state lives in Python lists: scalar numpy indexing would
        # dominate the runtime
        comp_start = [[nan] * Kc for _ in range(G)]
        comp_end = [[nan] * Kc for _ in range(G)]
        comp_ovl = [[0.0] * Kc for _ in range(G)]
        comm_lstart = np.full((G, Km), np.nan)
        comm_gend = [nan] * Km
        busy_time = [0.0] * G

        ci = [0] * G                          # compute cursor per device
        tdev = [0.0] * G                      # compute-frontier time
        gfr = [0.0] * G                       # in-flight kernel residues
        gbr = [0.0] * G
        started = [False] * G

        def advance(g, t_stop, slowed, until=-1):
            """Advance g's compute stream to t_stop (window mode) or until
            kernel `until` completes (target mode, t_stop=inf)."""
            t = tdev[g]
            i = ci[g]
            rf = rate_f_s[g] if slowed else rate_f[g]
            rmm = rm_s if slowed else rm
            cs, ce, ov = comp_start[g], comp_end[g], comp_ovl[g]
            wf, wb = work_f[g], work_b[g]
            ran_out = True
            while i < Kc:
                if not started[g]:
                    w = k_wait[i]
                    if w >= 0:
                        ge = comm_gend[w]
                        if ge != ge:          # NaN: gated on a future comm
                            if until >= 0:
                                raise RuntimeError(
                                    "C3Sim[batched]: deadlock — producer "
                                    "kernel gated on an unfinished comm")
                            t = t_stop
                            ran_out = False
                            break
                        if ge >= t_stop:      # gate opens at/after window end
                            t = t_stop
                            ran_out = False
                            break
                        if ge > t:
                            t = ge            # idle until the gate opens
                    cs[i] = t
                    gfr[g] = wf[i]
                    gbr[g] = wb[i]
                    started[g] = True
                dt = gfr[g] / rf + gbr[g] / rmm
                if t + dt <= t_stop:
                    if slowed:
                        ov[i] += dt
                    t = t + dt
                    ce[i] = t
                    busy_time[g] += t - cs[i]
                    started[g] = False
                    i += 1
                    if until >= 0 and i > until:
                        ran_out = False
                        break
                else:                          # partial progress to t_stop
                    dt_avail = t_stop - t
                    if dt_avail > 0:
                        if slowed:
                            ov[i] += dt_avail
                        use = min(dt_avail, gfr[g] / rf)
                        gfr[g] -= use * rf
                        gbr[g] = max(0.0, gbr[g] - (dt_avail - use) * rmm)
                    t = t_stop
                    ran_out = False
                    break
            if ran_out and t_stop != inf:      # stream exhausted this window
                t = t_stop
            ci[g] = i
            tdev[g] = t

        prev_end = 0.0
        arr = [0.0] * G
        for j in range(Km):
            prod = cprod[j]
            for g in range(G):
                if prod >= 0 and comp_end[g][prod] != comp_end[g][prod]:
                    advance(g, inf, slowed=False, until=prod)
                    if comp_end[g][prod] != comp_end[g][prod]:
                        raise RuntimeError("C3Sim[batched]: producer of comm "
                                           f"{j} never completed (deadlock)")
                    arr[g] = comp_end[g][prod]
                else:
                    arr[g] = prev_end
            comm_lstart[:, j] = arr
            prev_end = max(arr) + dur_comm_l[j]
            comm_gend[j] = prev_end
            for g in range(G):
                advance(g, prev_end, slowed=True)
        for g in range(G):                     # drain after the last barrier
            advance(g, inf, slowed=False)

        return self._make_trace(np.asarray(comp_start), np.asarray(comp_end),
                                np.asarray(comp_ovl), comm_lstart,
                                np.asarray(comm_gend), busy_time)


# --------------------------------------------------------------------------- #
# vector engine: the batched window algorithm, numpy-vectorized over lanes
# --------------------------------------------------------------------------- #
def vector_iteration(sims: Sequence["C3Sim"], freqs: Sequence[np.ndarray],
                     noises: Sequence[tuple]) -> List[IterationTrace]:
    """Run one iteration for B node-groups in a single vectorized pass.

    Every sim must share the same Workload (all devices execute the same
    kernel schedule — true for every fleet this repo builds), but presets
    and frequencies may differ per group (heterogeneous fleets).  Comm
    barriers are *per group*: group b's collective j globally ends at
    max over b's lanes only, exactly as if each group ran alone — so the
    traces are the batched/event engine's traces, computed over B*G numpy
    lanes instead of a Python loop per device.  This is the ROADMAP
    "vectorize the per-window device loop" speedup: per-kernel cost is one
    set of (B, G) array ops instead of B*G scalar loop bodies, which keeps
    topology sweeps over 8-32 nodes tractable.

    ``noises`` carries each sim's own `_draw_noise()` output so per-node
    RNG streams stay identical to a per-node run.
    """
    wl = sims[0].wl
    A = sims[0].arrays
    cfg = sims[0].cfg
    for s in sims[1:]:
        if s.arrays is not A:
            raise ValueError("vector_iteration: all sims must share one "
                             "Workload (kernel schedules must be identical)")
    B, G = len(sims), sims[0].G
    Kc, Km = len(wl.comp), len(wl.comm)
    k_wait = A["wait"]                               # (Kc,)
    cprod = A["cprod"]                               # (Km,)

    rate_f = np.empty((B, G))
    rm = np.empty((B, 1))
    for b, (s, f) in enumerate(zip(sims, freqs)):
        p = s.preset
        rate_f[b] = p.peak_gflops * cfg.gemm_eff * (np.asarray(f) / p.f_max)
        rm[b, 0] = p.hbm_gbps
    rate_f_s = rate_f / (1 + cfg.kappa_comp)
    rm_s = rm / (1 + cfg.kappa_mem)

    noise_c = np.stack([n for n, _ in noises])       # (B, G, Kc)
    dur_comm = np.stack([d for _, d in noises])      # (B, Km)
    work_f = A["gflop"][None, None, :] * noise_c
    work_b = A["gbyte"][None, None, :] * noise_c

    comp_start = np.full((B, G, Kc), np.nan)
    comp_end = np.full((B, G, Kc), np.nan)
    comp_ovl = np.zeros((B, G, Kc))
    comm_lstart = np.full((B, G, Km), np.nan)
    comm_gend = np.full((B, Km), np.nan)
    busy = np.zeros((B, G))

    t = np.zeros((B, G))
    ci = np.zeros((B, G), int)                       # compute cursor per lane
    started = np.zeros((B, G), bool)
    gfr = np.zeros((B, G))                           # in-flight residues
    gbr = np.zeros((B, G))

    def advance_full(until: int, need: np.ndarray,
                     allow_gate_stall: bool = False) -> None:
        """Complete kernels up to `until` at full rate on `need` lanes
        (batched engine's target mode).  `allow_gate_stall` is the drain
        semantics: a lane hitting an unopened gate stops instead of
        raising (its remaining kernels never ran)."""
        live = need.copy()
        while True:
            active = live & (ci <= until)
            if not active.any():
                return
            i = int(ci[active].min())
            m = active & (ci == i)
            ns = m & ~started
            if ns.any():
                w = int(k_wait[i])
                if w >= 0:
                    ge = comm_gend[:, w][:, None]    # (B, 1) broadcast
                    stalled = ns & np.isnan(ge)
                    if stalled.any():
                        if not allow_gate_stall:
                            raise RuntimeError(
                                "C3Sim[vector]: deadlock — producer kernel "
                                "gated on an unfinished comm")
                        live &= ~stalled
                        ns &= ~stalled
                        m &= ~stalled
                    t[ns] = np.maximum(t, np.broadcast_to(ge, t.shape))[ns]
                comp_start[:, :, i][ns] = t[ns]
                gfr[ns] = work_f[:, :, i][ns]
                gbr[ns] = work_b[:, :, i][ns]
                started[ns] = True
            if m.any():
                dt = gfr / rate_f + gbr / rm
                t[m] = (t + dt)[m]
                comp_end[:, :, i][m] = t[m]
                busy[m] += (t - comp_start[:, :, i])[m]
                started[m] = False
                ci[m] = i + 1

    def advance_window(t_stop: np.ndarray) -> None:
        """Advance every lane, slowed, to its group's window end `t_stop`
        (B,), with partial progress on the in-flight kernel (batched
        engine's window mode)."""
        ts = t_stop[:, None]                         # (B, 1)
        done = np.zeros((B, G), bool)
        while True:
            active = ~done & (ci < Kc)
            if not active.any():
                break
            i = int(ci[active].min())
            m = active & (ci == i)
            ns = m & ~started
            if ns.any():
                w = int(k_wait[i])
                if w >= 0:
                    ge = np.broadcast_to(comm_gend[:, w][:, None], t.shape)
                    closed = ns & (np.isnan(ge) | (ge >= ts))
                    done |= closed
                    ns &= ~closed
                    m &= ~closed
                    t[ns] = np.maximum(t, ge)[ns]
                comp_start[:, :, i][ns] = t[ns]
                gfr[ns] = work_f[:, :, i][ns]
                gbr[ns] = work_b[:, :, i][ns]
                started[ns] = True
            if m.any():
                dt = gfr / rate_f_s + gbr / rm_s
                fits = m & (t + dt <= ts)
                if fits.any():
                    comp_ovl[:, :, i][fits] += dt[fits]
                    t[fits] = (t + dt)[fits]
                    comp_end[:, :, i][fits] = t[fits]
                    busy[fits] += (t - comp_start[:, :, i])[fits]
                    started[fits] = False
                    ci[fits] = i + 1
                part = m & ~fits
                if part.any():
                    avail = np.broadcast_to(ts, t.shape) - t
                    pp = part & (avail > 0)
                    if pp.any():
                        comp_ovl[:, :, i][pp] += avail[pp]
                        use = np.minimum(avail, gfr / rate_f_s)
                        gfr[pp] = (gfr - use * rate_f_s)[pp]
                        gbr[pp] = np.maximum(
                            0.0, gbr - (avail - use) * rm_s)[pp]
                    done |= part
        t[:, :] = ts                                 # all lanes end at stop

    prev_end = np.zeros(B)
    for j in range(Km):
        prod = int(cprod[j])
        if prod >= 0:
            need = np.isnan(comp_end[:, :, prod])
            if need.any():
                advance_full(prod, need)
            arr = np.where(need, comp_end[:, :, prod], prev_end[:, None])
        else:
            arr = np.broadcast_to(prev_end[:, None], (B, G)).copy()
        comm_lstart[:, :, j] = arr
        prev_end = arr.max(axis=1) + dur_comm[:, j]
        comm_gend[:, j] = prev_end
        advance_window(prev_end)
    advance_full(Kc - 1, ci < Kc, allow_gate_stall=True)   # drain

    return [sims[b]._make_trace(comp_start[b], comp_end[b], comp_ovl[b],
                                comm_lstart[b], comm_gend[b], busy[b])
            for b in range(B)]


class NodeSim:
    """Closed-loop node: C3 execution × thermal/DVFS physics per iteration."""

    def __init__(self, workload: Workload, preset: DevicePreset,
                 sim_cfg: SimConfig, n_devices: int = 8, seed: int = 0,
                 straggler_boost: float = 1.28,
                 churn: Optional[ChurnModel] = None):
        self.thermal = ThermalModel(preset, n_devices, seed=seed,
                                    straggler_boost=straggler_boost,
                                    churn=churn)
        self.sim = C3Sim(workload, preset, sim_cfg, n_devices)
        self.state = self.thermal.init_state()
        self.G = n_devices
        self.preset = preset
        self.history: List[dict] = []
        self.iteration = 0
        # telemetry hook (repro.telemetry.TelemetryCollector.attach_node):
        # None during warmup, so recordings start at operational time zero
        self.collector = None
        # fault-injection hook (repro.core.faults via ClusterSim): per-device
        # compute-rate multiplier (perf_degrade / device_loss); the device
        # still draws power at its governed frequency — sick silicon burns
        # watts without doing work.  None keeps execution bit-identical.
        self.perf_scale: Optional[np.ndarray] = None
        # warm up thermals: a few iterations to reach operating temperature
        for _ in range(30):
            self.step()
        self.history.clear()
        # churn clocks start at operational time zero, post warm-up
        self.thermal.t_sim = 0.0

    def set_power_caps(self, caps: np.ndarray) -> None:
        """Apply per-device power caps (W), as a fleet manager would; DVFS
        converges toward them on subsequent `commit` calls."""
        self.state.cap = np.asarray(caps, float).copy()

    def run_only(self) -> IterationTrace:
        """Execute one iteration at current frequencies without committing
        physics — a cluster layer runs all nodes first, then commits with
        the global (barrier-stretched) interval."""
        self._freq_used = self.state.freq.copy()
        if self.perf_scale is not None:
            self._freq_used = self._freq_used * self.perf_scale
        return self.sim.run_iteration(self._freq_used)

    def commit(self, trace: IterationTrace,
               t_interval: Optional[float] = None,
               active_wait: bool = False) -> None:
        """Thermal/DVFS update over `t_interval` (default: local t_iter).
        When the node is barrier-bound by a slower peer, its devices idle
        for t_interval - t_iter, lowering utilization (and so power) over
        the stretched interval.  Under `active_wait` (tensor parallelism)
        the wait happens *inside* collective kernels that keep the device
        near peak power — utilization stays high over the whole interval,
        so waiting on a straggler heats the waiters (paper §II-B)."""
        t = trace.t_iter if t_interval is None else t_interval
        if active_wait:
            util = (trace.util * trace.t_iter + (t - trace.t_iter)) / t
        else:
            util = trace.util * (trace.t_iter / t)
        self.thermal.update(self.state, util, t)
        self.history.append({
            "iter": self.iteration,
            "freq_used": self._freq_used,
            "t_iter": t,
            "t_local": trace.t_iter,
            "freq": self.state.freq.copy(),
            "temp": self.state.temp.copy(),
            "power": self.state.power.copy(),
            "cap": self.state.cap.copy(),
            "throughput": 1.0 / t,
            "energy": float(np.sum(self.state.power) * t),
        })
        if self.collector is not None:
            self.collector.on_node_commit(self, trace, t, self.iteration)
        self.iteration += 1

    def step(self) -> IterationTrace:
        """One standalone iteration: `run_only` then `commit` with the
        node's own t_iter (no barrier stretching)."""
        trace = self.run_only()
        self.commit(trace)
        return trace
