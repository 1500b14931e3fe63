"""The port's fleet simulator engine against the JAX package, on the CPU.

``engine="torch"`` (``repro_torch.core.torch_engine``: the window scan, whose
plain version runs on a CPU tensor) against the JAX package's
``engine="jax"`` and the port's own vector engine, on the same numpy noise;
``run_fleet_scan`` against the JAX package's; the cluster simulator, its
backends and the fleet power manager against theirs.

The JAX engine's module imports ``enable_x64`` from ``jax.experimental``,
which the installed JAX (0.9) no longer has (it is ``jax.enable_x64``), so
in this environment ``repro.core.jax_engine.HAS_JAX`` is False and the JAX
package's own engine tests skip.  The ``jax_engine`` fixture loads the same
source as a module of its own with that one import pointed at
``jax.enable_x64``, and a test that drives the JAX package's
``ClusterSim(engine="jax")`` puts it in ``sys.modules`` for that test only.

Tolerances: rtol 1e-9, atol 1e-12 with equal NaN patterns, the JAX
package's own for ``engine="jax"`` against the vector engine
(tests/test_jax_engine.py:54-62: float64 sums in another order); the
managed fleet's caps and history 1e-9.  The fleet scans: the port draws
the JAX package's own threefry2x32 streams (``repro_torch.core.prng``, the
kernel's draw form), so with the noise, spikes and TP jitter on, as with
them off, every series and the final state agree within rtol 1e-9, atol
1e-12, and the slowest and straggler nodes are equal; the draws differ
from JAX's only where torch's ``erfinv`` and ``exp`` round otherwise than
XLA's (about 1e-14 relative in a noise factor).  Against stepping
``ClusterSim``, whose noise is numpy's, the tail means (last 30
iterations) of t_fleet, throughput and fleet power hold at rel 5e-3, the
JAX package's statistical limit (tests/test_jax_engine.py:115): the
streams differ, the physics does not.
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.jax_engine as jax_engine_module
from repro.configs import get_config as jax_config
from repro.core.backends import ClusterSimBackend as JClusterSimBackend
from repro.core.c3sim import C3Sim as JC3Sim
from repro.core.c3sim import SimConfig as JSimConfig
from repro.core.cluster import ClusterConfig as JClusterConfig
from repro.core.cluster import ClusterSim as JClusterSim
from repro.core.faults import FaultEvent as JFaultEvent
from repro.core.faults import FaultModel as JFaultModel
from repro.core.manager import FleetManagerConfig as JFleetManagerConfig
from repro.core.manager import run_fleet_closed_loop as jax_closed_loop
from repro.core.thermal import MI300X_PRESET as J_MI300X
from repro.core.thermal import ChurnEvent as JChurnEvent
from repro.core.thermal import ChurnModel as JChurnModel
from repro.core.workload import fsdp_llm_iteration as jax_workload
from repro_torch.configs import get_config
from repro_torch.core import torch_engine
from repro_torch.core.backends import ClusterSimBackend
from repro_torch.core.c3sim import C3Sim, SimConfig, vector_iteration
from repro_torch.core import cluster as cluster_module
from repro_torch.core.cluster import ClusterConfig, ClusterSim
from repro_torch.core.faults import FaultEvent, FaultModel
from repro_torch.core.manager import (FleetManagerConfig, FleetPowerManager,
                                      run_fleet_closed_loop)
from repro_torch.core.thermal import MI300X_PRESET, ChurnEvent, ChurnModel
from repro_torch.core.workload import (CommKernel, CompKernel, Workload,
                                       fsdp_llm_iteration)
from repro_torch.kernels.c3_window import c3_window, c3_window_ref

RTOL, ATOL = 1e-9, 1e-12
STAT_REL = 5e-3
HETERO = ["mi300x", "mi300x-air", "mi300x", "v5e"]
CAP_W = 700.0
TRACE_FIELDS = ("comp_start", "comp_end", "comp_overlap", "comm_start",
                "comm_end", "util")


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX package's ``core/jax_engine.py``, its x64 import adapted to
    the installed JAX, as a module of its own."""
    path = Path(jax_engine_module.__file__)
    src = path.read_text()
    old = "from jax.experimental import enable_x64"
    assert old in src
    mod = types.ModuleType("repro_jax_engine_x64")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod          # dataclasses look it up
    exec(compile(src.replace(old, "from jax import enable_x64"), str(path),
                 "exec"), mod.__dict__)
    assert mod.HAS_JAX
    return mod


@pytest.fixture
def jax_engine_installed(jax_engine, monkeypatch):
    """The adapted module as ``repro.core.jax_engine`` for one test, where
    the JAX package's ClusterSim and C3Sim import ``jax_iteration``."""
    monkeypatch.setitem(sys.modules, "repro.core.jax_engine", jax_engine)
    return jax_engine


def _workloads(arch="llama3.1-8b", n_layers=2):
    """The same FSDP iteration from both packages' configs."""
    kw = dict(batch=2, seq=4096, n_shards=8)
    return (jax_workload(jax_config(arch).replace(n_layers=n_layers), **kw),
            fsdp_llm_iteration(get_config(arch).replace(n_layers=n_layers),
                               **kw))


def _cluster_kw(topo, hetero, churn, jax_side):
    kw = dict(n_nodes=4, straggler_boost=1.28, topology=topo)
    if hetero:
        kw["node_presets"] = HETERO
    if churn:
        ev, cm = (JChurnEvent, JChurnModel) if jax_side else \
            (ChurnEvent, ChurnModel)
        kw["churn"] = {0: cm(drift_rate=0.3, events=[ev(0.0, 3, 1.4)])}
    return kw


def _clusters(engines, topo="dp", seed=5, hetero=False, churn=False,
              n_nodes=4, faults=None, **fault_kw):
    """{engine: cluster}: "jax" the JAX package's, others the port's, all
    at 700 W caps after the warmup (the cluster scenarios' setting).
    ``faults`` makes each side's ``FaultModel`` from (FaultEvent,
    FaultModel)."""
    jwl, twl = _workloads()
    sim_kw = dict(seed=1, comm_gbps=40.0)
    out = {}
    for engine in engines:
        if engine == "jax":
            kw = dict(_cluster_kw(topo, hetero, churn, True), n_nodes=n_nodes)
            fm = faults(JFaultEvent, JFaultModel) if faults else None
            c = JClusterSim(jwl, J_MI300X, JSimConfig(**sim_kw),
                            JClusterConfig(engine="jax", **kw),
                            devices_per_node=8, seed=seed, faults=fm,
                            **fault_kw)
        else:
            kw = dict(_cluster_kw(topo, hetero, churn, False),
                      n_nodes=n_nodes)
            fm = faults(FaultEvent, FaultModel) if faults else None
            c = ClusterSim(twl, MI300X_PRESET,
                           SimConfig(**sim_kw, device="cpu"),
                           ClusterConfig(engine=engine, **kw),
                           devices_per_node=8, seed=seed, faults=fm,
                           **fault_kw)
        for n in range(c.N):
            c.set_node_caps(n, np.full(c.G, CAP_W))
        out[engine] = c
    return out


def _assert_traces_close(ta, tb, what):
    for field in TRACE_FIELDS:
        a, b = getattr(ta, field), getattr(tb, field)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=f"{what} {field}: NaN pattern")
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True,
                                   err_msg=f"{what} {field}")
    assert ta.t_iter == pytest.approx(tb.t_iter, rel=RTOL), what


def _assert_history_close(ha, hb):
    assert len(ha) == len(hb)
    for ra, rb in zip(ha, hb):
        for key in ("t_local", "t_fleet", "node_power", "power", "lead"):
            np.testing.assert_allclose(ra[key], rb[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
        assert ra["slowest_node"] == rb["slowest_node"]
        assert ("t_sim" in ra) == ("t_sim" in rb)
        if "t_sim" in ra:
            assert ra["t_sim"] == pytest.approx(rb["t_sim"], rel=RTOL)
            np.testing.assert_array_equal(ra["sensor_dead"],
                                          rb["sensor_dead"])


# --------------------------------------------------------------------------- #
# the static plan and the fleet arrays (numpy copies)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,n_layers", [("llama3.1-8b", 8),
                                           ("deepseek-v3-16b", 3)])
def test_window_plan_and_step_table_match_jax(jax_engine, arch, n_layers):
    jwl, twl = _workloads(arch, n_layers)
    jp, tp = jax_engine.window_plan(jwl), torch_engine.window_plan(twl)
    assert torch_engine.window_plan(twl) is tp          # cached
    for field in ("n_comp", "n_comm", "cprod", "k_wait", "arrival",
                  "window", "drain_lo"):
        assert getattr(jp, field) == getattr(tp, field), field
    assert jp.n_steps == tp.n_steps
    for a, b in zip(jax_engine._step_table(jp), torch_engine._step_table(tp)):
        np.testing.assert_array_equal(a, b)
    if (arch, n_layers) == ("llama3.1-8b", 8):
        assert len(torch_engine._step_table(tp)[0]) == 465


def test_build_fleet_arrays_match_jax_bit_for_bit(jax_engine):
    jwl, twl = _workloads()
    for topo in ("dp", "tp"):
        jcc = JClusterConfig(**_cluster_kw(topo, True, True, True))
        tcc = ClusterConfig(**_cluster_kw(topo, True, True, False))
        ja = jax_engine.build_fleet_arrays(jwl, J_MI300X, JSimConfig(),
                                           jcc, CAP_W, seed=11, rng_seed=3)
        ta = torch_engine.build_fleet_arrays(twl, MI300X_PRESET, SimConfig(),
                                             tcc, CAP_W, seed=11, rng_seed=3)
        assert set(ja) == set(ta)
        for key in ja:
            if key != "key":
                assert ja[key].dtype == ta[key].dtype, key
                np.testing.assert_array_equal(ja[key], ta[key], err_msg=key)
        assert jax_engine.fleet_scan_spec(jwl, JSimConfig(), jcc, 7) \
            .tp_syncs == torch_engine.fleet_scan_spec(
                twl, SimConfig(), tcc, 7).tp_syncs


# --------------------------------------------------------------------------- #
# one iteration from the vector engine's numpy noise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("topo", ["dp", "pp", "tp"])
@pytest.mark.parametrize("mixed", [False, True], ids=["plain", "hetero_churn"])
def test_cluster_torch_engine_matches_jax_and_vector(jax_engine_installed,
                                                     topo, mixed):
    """ClusterSim(engine="torch") steps all N*G lanes through the window
    scan and emits the traces of the JAX package's engine="jax" and of the
    port's engine="vector" (the same numpy noise), history for history."""
    cs = _clusters(("torch", "vector", "jax"), topo, seed=7 if mixed else 5,
                   hetero=mixed, churn=mixed)
    for _ in range(3):
        tt, tv, tj = (cs[e].step() for e in ("torch", "vector", "jax"))
        for a, b, c in zip(tt, tv, tj):
            _assert_traces_close(a, b, "torch vs vector")
            _assert_traces_close(a, c, "torch vs jax")
    _assert_history_close(cs["torch"].history, cs["jax"].history)
    _assert_history_close(cs["torch"].history, cs["vector"].history)


def test_c3sim_torch_engine_matches_jax(jax_engine_installed):
    """C3Sim.run_iteration(engine="torch") on one node is a one-group call
    of the same scan; the JAX package's engine="jax" on the same seed."""
    jwl, twl = _workloads()
    freq = MI300X_PRESET.f_max * np.linspace(0.8, 1.0, 8)
    js = JC3Sim(jwl, J_MI300X, JSimConfig(seed=3, comm_gbps=40.0), 8)
    ts = C3Sim(twl, MI300X_PRESET, SimConfig(seed=3, comm_gbps=40.0,
                                             device="cpu"), 8)
    for _ in range(2):
        _assert_traces_close(ts.run_iteration(freq, engine="torch"),
                             js.run_iteration(freq, engine="jax"),
                             "c3sim torch vs jax")


def _count_torch_iterations(monkeypatch):
    """Counts ClusterSim's calls of the torch engine."""
    calls = []

    def counted(*args, **kw):
        calls.append(len(args[0]))
        return torch_engine.torch_iteration(*args, **kw)

    monkeypatch.setattr(cluster_module, "torch_iteration", counted)
    return calls


def test_one_node_cluster_runs_the_torch_engine(jax_engine_installed,
                                                monkeypatch):
    """A fleet of one node still steps through the torch engine (one group
    of G lanes), not the host's per-node engine, and matches the JAX
    package's engine="jax" and the port's engine="vector" (whose one-node
    fleet runs the batched engine), history for history."""
    calls = _count_torch_iterations(monkeypatch)
    cs = _clusters(("torch", "vector", "jax"), n_nodes=1)
    for _ in range(3):
        tt, tv, tj = (cs[e].step() for e in ("torch", "vector", "jax"))
        _assert_traces_close(tt[0], tv[0], "torch vs vector")
        _assert_traces_close(tt[0], tj[0], "torch vs jax")
    assert calls == [1, 1, 1]
    _assert_history_close(cs["torch"].history, cs["jax"].history)
    _assert_history_close(cs["torch"].history, cs["vector"].history)


def _faults(Event, Model):
    """Every fault kind, on global node ids 3, 0, 5 and 1 (the fleet's
    local nodes 0-3 under ``fault_nodes``) and on node 9, outside it; the
    fleet's clock starts at 10 s and an iteration takes ~0.18 s."""
    return Model([
        Event(10.0, "thermal_runaway", node=0, device=4, magnitude=0.5),
        Event(10.2, "perf_degrade", node=0, device=2, magnitude=0.6,
              duration=0.5),
        Event(10.35, "kernel_hang", node=3, magnitude=2.0, duration=0.4),
        Event(10.4, "sensor_death", node=1, duration=0.5),
        Event(10.6, "device_loss", node=5, device=7),
        Event(10.0, "perf_degrade", node=9, device=0, magnitude=0.1),
    ])


@pytest.mark.parametrize("topo", ["dp", "tp"])
def test_cluster_faults_match_jax_and_vector(jax_engine_installed,
                                             monkeypatch, topo):
    """Fault injection through ClusterSim: the perf scales feed the torch
    engine's frequencies, hangs stretch t_local, dead sensors mark the
    history, a thermal runaway grows r_th; the port's torch and vector
    engines against the JAX package's engine="jax", trace for trace and
    history for history, on a fleet that maps its nodes to global ids and
    starts its clock at 10 s."""
    calls = _count_torch_iterations(monkeypatch)
    cs = _clusters(("torch", "vector", "jax"), topo, faults=_faults,
                   fault_nodes=[3, 0, 5, 1], fault_t0=10.0)
    for _ in range(8):
        tt, tv, tj = (cs[e].step() for e in ("torch", "vector", "jax"))
        for a, b, c in zip(tt, tv, tj):
            _assert_traces_close(a, b, "torch vs vector")
            _assert_traces_close(a, c, "torch vs jax")
    assert calls == [4] * 8
    h = cs["torch"].history
    # the faults showed: the hang on local node 0, the lost device in local
    # node 2's frequencies, the dead sensor on local node 3 alone
    assert any(r["t_local"][0] > 1.5 * np.median(r["t_local"]) for r in h)
    assert any(r["sensor_dead"][3] for r in h)
    assert not any(r["sensor_dead"][:3].any() for r in h)
    used = cs["torch"].nodes[2]._freq_used
    assert used[7] < 0.1 * used[:7].min()
    _assert_history_close(h, cs["jax"].history)
    _assert_history_close(h, cs["vector"].history)


def _edge_workloads():
    comp = [CompKernel(f"k{i}", gflop=40.0 + 7 * i, gbyte=0.2 + 0.05 * i)
            for i in range(6)]
    no_comm = Workload(comp=[CompKernel(k.name, k.gflop, k.gbyte)
                             for k in comp], comm=[], name="no-comm")
    # comm 0's producer is kernel 1 and kernel 2 waits on it: window 0 holds
    # no kernel; comm 1 has no producer (every lane arrives at the barrier)
    comp[2].wait_comm = 0
    comp[4].wait_comm = 1
    gated = Workload(comp=comp, comm=[CommKernel("c0", 2e8, producer=1),
                                      CommKernel("c1", 1e8)], name="gated")
    return {"no-comm": no_comm, "empty-window": gated}


@pytest.mark.parametrize("G", [8, 3])
@pytest.mark.parametrize("case", ["no-comm", "empty-window", "llama"])
def test_window_scan_edge_cases_match_vector(case, G):
    """The scan's edge cases against the vector engine on the same noise:
    Km 0, a window with no kernel, and groups of 3 (the kernel's shared
    memory path); summary mode against the emitted trace."""
    wl = (_workloads()[1] if case == "llama" else _edge_workloads()[case])
    plan = torch_engine.window_plan(wl)
    if case == "empty-window":
        assert plan.window[0][0] == plan.window[0][1]       # no kernel
        assert plan.arrival[1] == (0, 0)                     # no producer
    if case == "no-comm":
        assert plan.n_comm == 0
    sims = [C3Sim(wl, MI300X_PRESET, SimConfig(seed=b, comm_gbps=40.0), G)
            for b in range(5)]
    rng = np.random.default_rng(G)
    freqs = [MI300X_PRESET.f_max * rng.uniform(0.5, 1.0, G) for _ in sims]
    noises = [s._draw_noise() for s in sims]
    tt = torch_engine.torch_iteration(sims, freqs, noises, device="cpu")
    tv = vector_iteration(sims, freqs, noises)
    for a, b in zip(tt, tv):
        _assert_traces_close(a, b, f"{case} G {G}")
    # summary mode: the same t_iter and util as the trace
    A = sims[0].arrays
    Kc = len(wl.comp)
    f64 = torch.float64
    rate_f = torch.tensor(np.stack([
        s.preset.peak_gflops * s.cfg.gemm_eff * (f / s.preset.f_max)
        for s, f in zip(sims, freqs)]).reshape(-1), dtype=f64)
    rm = torch.full((len(sims),), MI300X_PRESET.hbm_gbps, dtype=f64)
    cfg = sims[0].cfg
    noise = torch.tensor(np.stack([n for n, _ in noises])
                         .reshape(-1, Kc).T.copy()[None], dtype=f64)
    dur = torch.tensor(np.stack([d for _, d in noises]).reshape(len(sims), -1),
                       dtype=f64)
    t_iter, util = c3_window(
        torch_engine._table(plan, "cpu"), rate_f,
        rate_f / (1.0 + cfg.kappa_comp), rm, rm / (1.0 + cfg.kappa_mem),
        noise, torch.tensor(A["gflop"]), torch.tensor(A["gbyte"]), dur, G,
        emit=False)
    np.testing.assert_allclose(t_iter.numpy(), [tr.t_iter for tr in tv],
                               rtol=RTOL)
    np.testing.assert_allclose(util.numpy().reshape(len(sims), G),
                               np.stack([tr.util for tr in tv]), rtol=RTOL,
                               atol=ATOL)


def test_window_scan_planted_fault_is_caught():
    """The check the kernel is held to catches a wrong input: durations
    shifted by one comm move the trace far past the tolerance."""
    wl = _workloads()[1]
    plan = torch_engine.window_plan(wl)
    A = wl._c3_arrays
    Kc, Km, G, B = plan.n_comp, plan.n_comm, 8, 3
    gen = np.random.default_rng(0)
    f64 = torch.float64
    rate_f = torch.tensor(gen.uniform(3e5, 6e5, B * G), dtype=f64)
    rm = torch.full((B,), 5300.0, dtype=f64)
    noise = torch.tensor(np.exp(0.008 * gen.standard_normal((1, Kc, B * G))),
                         dtype=f64)
    dur = torch.tensor(A["cbytes"] / 40e9 * np.exp(
        0.008 * gen.standard_normal((B, Km))), dtype=f64)
    args = (torch_engine._table(plan, "cpu"), rate_f, rate_f / 1.45, rm,
            rm / 1.75, noise, torch.tensor(A["gflop"]),
            torch.tensor(A["gbyte"]))
    want = c3_window_ref(*args, dur, G, emit=True)
    got = c3_window_ref(*args, dur.roll(1, dims=1), G, emit=True)
    diff = (got[1] - want[1]).abs() / want[1].abs()
    assert float(diff.nan_to_num(0.0).max()) > 1e3 * RTOL


# --------------------------------------------------------------------------- #
# the managed fleet
# --------------------------------------------------------------------------- #
def test_managed_fleet_matches_jax(jax_engine_installed):
    """run_fleet_closed_loop over the torch engine against the JAX
    package's over engine="jax": the hierarchical manager (gpu-realloc, the
    cluster scenarios' knobs) takes the same decisions, caps and t_fleet
    history within 1e-9."""
    cs = _clusters(("torch", "jax"))
    knobs = dict(use_case="gpu-realloc", sampling_period=2, warmup=2,
                 window_size=2, node_window_size=2, power_cap=CAP_W,
                 cluster_power_budget=4 * 8 * CAP_W)
    tm = run_fleet_closed_loop(ClusterSimBackend(cs["torch"]),
                               FleetManagerConfig(**knobs), 36, tune_after=8)
    jm = jax_closed_loop(JClusterSimBackend(cs["jax"]),
                         JFleetManagerConfig(**knobs), 36, tune_after=8)
    assert len(tm.budget_log) == len(jm.budget_log) > 0
    np.testing.assert_allclose(np.stack(tm.budget_log),
                               np.stack(jm.budget_log), rtol=RTOL)
    for n in range(4):
        np.testing.assert_allclose(cs["torch"].get_node_caps(n),
                                   cs["jax"].get_node_caps(n), rtol=RTOL)
    np.testing.assert_allclose([h["t_fleet"] for h in cs["torch"].history],
                               [h["t_fleet"] for h in cs["jax"].history],
                               rtol=RTOL)


def test_collector_raises_and_names_the_scenario_api():
    c = _clusters(("vector",))["vector"]
    with pytest.raises(NotImplementedError, match="scenario API"):
        ClusterSimBackend(c, collector=object())
    cfg = FleetManagerConfig(use_case="gpu-realloc")
    with pytest.raises(NotImplementedError, match="scenario API"):
        FleetPowerManager(ClusterSimBackend(c), cfg, collector=object())
    with pytest.raises(NotImplementedError, match="scenario API"):
        run_fleet_closed_loop(ClusterSimBackend(c), cfg, 2,
                              collector=object())


# --------------------------------------------------------------------------- #
# the fleet scan
# --------------------------------------------------------------------------- #
def _scan_inputs(jax_engine, topo, collect, samples, noise, iterations,
                 spike_p=0.0):
    """Stacked (samples > 0) or single fleet arrays from both packages,
    with churn and mixed presets; noise 0 and no TP jitter make the run
    deterministic."""
    jwl, twl = _workloads()
    extra = dict(tp_jitter=0.0) if noise == 0.0 else {}
    jcc = JClusterConfig(**_cluster_kw(topo, True, True, True), **extra)
    tcc = ClusterConfig(**_cluster_kw(topo, True, True, False), **extra)
    sim_kw = dict(seed=1, comm_gbps=40.0, noise=noise, comm_spike_p=spike_p)
    js = JSimConfig(**sim_kw)
    ts = SimConfig(**sim_kw)
    out = []
    for eng, wl, sim, cc, preset in ((jax_engine, jwl, js, jcc, J_MI300X),
                                     (torch_engine, twl, ts, tcc,
                                      MI300X_PRESET)):
        spec = eng.fleet_scan_spec(wl, sim, cc, iterations, collect=collect)
        arrays = [eng.build_fleet_arrays(wl, preset, sim, cc, CAP_W, 5 + k,
                                         rng_seed=k)
                  for k in range(max(samples, 1))]
        if samples:
            arrays = {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}
        else:
            arrays = arrays[0]
        out.append((spec, arrays))
    return out


SCAN_CASES = [("dp", "full", 2), ("dp", "summary", 0), ("pp", "full", 0),
              ("pp", "summary", 2), ("tp", "full", 2), ("tp", "summary", 2)]


def _assert_scans_match(jo, to):
    assert set(jo) == set(to)
    for key in jo:
        a, b = np.asarray(jo[key]), to[key]
        assert a.shape == b.shape, key
        if key in ("slowest_node", "straggler_node"):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("topo,collect,samples", SCAN_CASES)
def test_fleet_scan_matches_jax_when_deterministic(jax_engine, topo, collect,
                                                   samples):
    """With the noise at 0, no spikes and no TP jitter both scans are
    deterministic: every series and the final thermal state agree, with
    churn, mixed presets, and with or without a leading sample axis."""
    (jspec, ja), (tspec, ta) = _scan_inputs(jax_engine, topo, collect,
                                            samples, 0.0, 24)
    _assert_scans_match(jax_engine.run_fleet_scan(jspec, ja),
                        torch_engine.run_fleet_scan(tspec, ta, device="cpu"))


@pytest.mark.parametrize("topo,collect,samples", SCAN_CASES)
def test_fleet_scan_matches_jax_with_noise(jax_engine, topo, collect,
                                           samples):
    """With the noise on (0.008), comm spikes (p 0.2) and the default TP
    jitter, the port's scan draws what the JAX package's draws from the
    same keys: every series and the final state agree within rtol 1e-9,
    the slowest and straggler nodes are equal."""
    (jspec, ja), (tspec, ta) = _scan_inputs(jax_engine, topo, collect,
                                            samples, 0.008, 24, spike_p=0.2)
    assert jspec.spike and tspec.spike
    assert (float(np.min(ja["tp_jitter"])) > 0.0) == (topo == "tp")
    _assert_scans_match(jax_engine.run_fleet_scan(jspec, ja),
                        torch_engine.run_fleet_scan(tspec, ta, device="cpu"))


def _tail_means(t_fleet, power, n=30):
    t, p = np.asarray(t_fleet)[-n:], np.asarray(power)[-n:]
    return {"t_fleet": t.mean(), "throughput": (1.0 / t).mean(),
            "power": p.mean()}


def test_fleet_scan_statistics_match_jax_and_cluster_stepping(jax_engine):
    """At the default noise the scans' streams (jax.random's, replayed by
    the port) differ from ClusterSim's (numpy's) but the physics does not:
    per sample, the tail means of t_fleet, throughput and fleet power of
    the port's scan agree with the JAX package's scan and with stepping the
    port's ClusterSim."""
    samples, iters = 3, 40
    (jspec, ja), (tspec, ta) = _scan_inputs(jax_engine, "dp", "summary",
                                            samples, 0.008, iters)
    jo = jax_engine.run_fleet_scan(jspec, ja)
    to = torch_engine.run_fleet_scan(tspec, ta, device="cpu")
    _, twl = _workloads()
    for k in range(samples):
        c = ClusterSim(twl, MI300X_PRESET, SimConfig(seed=1, comm_gbps=40.0),
                       ClusterConfig(engine="vector", **_cluster_kw(
                           "dp", True, True, False)),
                       devices_per_node=8, seed=5 + k)
        for n in range(c.N):
            c.set_node_caps(n, np.full(c.G, CAP_W))
        for _ in range(iters):
            c.step()
        stepped = _tail_means([h["t_fleet"] for h in c.history],
                              [h["power"] for h in c.history])
        ours = _tail_means(to["t_fleet"][k], to["fleet_power"][k])
        theirs = _tail_means(jo["t_fleet"][k], jo["fleet_power"][k])
        for key in ours:
            assert ours[key] == pytest.approx(theirs[key], rel=STAT_REL), key
            assert ours[key] == pytest.approx(stepped[key], rel=STAT_REL), key


def test_fleet_scan_population_equals_its_samples_run_alone():
    """Each sample draws from its own key's streams: a sample's run does not
    depend on the population around it."""
    jwl, twl = _workloads()
    cc = ClusterConfig(n_nodes=3, topology="tp")
    sim = SimConfig(comm_spike_p=0.2)
    spec = torch_engine.fleet_scan_spec(twl, sim, cc, 6, collect="full")
    arrays = [torch_engine.build_fleet_arrays(twl, MI300X_PRESET, sim, cc,
                                              CAP_W, 5 + k, rng_seed=k)
              for k in range(2)]
    pop = torch_engine.run_fleet_scan(
        spec, {k: np.stack([a[k] for a in arrays]) for k in arrays[0]},
        device="cpu")
    alone = torch_engine.run_fleet_scan(spec, arrays[1], device="cpu")
    for key, v in alone.items():
        np.testing.assert_array_equal(pop[key][1], v, err_msg=key)


# --------------------------------------------------------------------------- #
# where the engine runs
# --------------------------------------------------------------------------- #
def test_torch_engine_defaults_to_cuda_and_raises_without_it():
    assert SimConfig().device == "cuda"
    assert not hasattr(ClusterConfig(), "device")     # SimConfig's alone
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check needs a host without it")
    _, twl = _workloads()
    sim = C3Sim(twl, MI300X_PRESET, SimConfig(), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.run_iteration(np.full(8, 2.1), engine="torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterSim(twl, MI300X_PRESET, SimConfig(),
                   ClusterConfig(n_nodes=2, engine="torch")).step()
    spec = torch_engine.fleet_scan_spec(twl, SimConfig(), ClusterConfig(), 2)
    arrays = torch_engine.build_fleet_arrays(twl, MI300X_PRESET, SimConfig(),
                                             ClusterConfig(), None, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_engine.run_fleet_scan(spec, arrays)


def test_engine_jax_names_the_torch_engine():
    _, twl = _workloads()
    with pytest.raises(ValueError, match="'torch'"):
        ClusterSim(twl, MI300X_PRESET, SimConfig(),
                   ClusterConfig(engine="jax"))
    with pytest.raises(ValueError, match="'torch'"):
        C3Sim(twl, MI300X_PRESET, SimConfig(), 8).run_iteration(
            np.full(8, 2.1), engine="jax")
