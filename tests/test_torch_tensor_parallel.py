"""The port's tensor, sequence and expert parallelism over the ``model``
axis, on the CPU over gloo.

* Worlds 2 (mesh (1, 2)), 4 ((2, 2) and (1, 4)) and 8 ((2, 4), the mesh of
  ``tests/test_multidevice.py:68``) of processes (``torch.multiprocessing``,
  gloo), each group spawned once, against the single-process ``Trainer``
  at the same seed, with ``sequence_parallel`` on and off: reduced fp32
  llama3.1-8b (at m = 4 its 4/2 heads leave the kv heads whole), a variant
  whose heads divide m and whose kv heads do not (4/1: wk and wv whole,
  each local query head reading its kv head), one where neither divides
  (3/1: attention whole on every model rank), and reduced fp32
  deepseek-v3-16b with capacity factor 0.5, so that tokens drop (expert
  parallel: each model rank runs its E/m experts).  Each step's loss, CE,
  z-loss, aux, token count and gradient norm within 2e-5 (the JAX
  package's fp32 tolerance, ``tests/test_kernels.py``); every leaf's
  first-step gradient, gathered over both axes, within 2e-5 of the leaf's
  largest magnitude; the moments after 3 steps, gathered leaf by leaf into
  a checkpoint, within 1e-4 of each leaf's largest, and the parameters
  too where the first step's gradient is above the fp32 rounding of its
  sum (``PARAM_FLOOR`` says why: AdamW moves an element whose gradient is
  rounding noise by a whole ``lr`` step of either sign; a wrong split
  moves a leaf by ``lr``, 3e-3 of it, and a lost or doubled model
  reduction moves the moments by 50-300%).
* The (2, 2) mesh against JAX's ``build_train_step`` on one device, from
  the same JAX-made initial state, for llama3.1-8b and for
  deepseek-v3-16b with drops.
* Checkpoints: a (2, 2) checkpoint restores in a single-process
  ``Trainer`` and through the JAX ``CheckpointManager``; a single-process
  checkpoint restores at (2, 2) and training goes on to the
  single-process losses.
* ``launch.train.main`` with ``--model-parallel 2`` under a
  torchrun-shaped environment at world 2: the loss falls by 0.2 in 30
  steps, and rank 0 prints the mesh.
* On the (2, 2) mesh: FSDP's overlap (the data group's gathers a layer
  ahead, its reduce-scatters in flight; the model group's collectives
  where they were) against ``FSDP(prefetch=False)``, llama and MoE with
  drops, sequence parallel: the metrics and the state after 3 steps equal
  bit for bit, at most one layer gathered ahead; ``explicit_overlap``
  trains the default step bit for bit; int8 compression trains, each
  step's metrics within 2e-5 of one process with it.
* Without processes: the kv-head mapping of attention over split heads,
  the vocab-parallel lookup, ``act.constrain``'s blocks, and what stays
  out (serving over ``model``, experts ``model`` does not divide,
  ``multi_pod``, the remat policies) raising, and no fallback.

JAX is imported only by the cases that compare with it, so the spawned
processes, which import this module, start without it.
"""
import contextlib
import dataclasses
import io
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import ParallelConfig, TrainConfig
from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
from repro_torch.models import attention as attn
from repro_torch.models.common import tree_leaves
from repro_torch.models.moe import capacity
from repro_torch.parallel import act
from repro_torch.parallel.fsdp import FSDP
from repro_torch.parallel.mesh import make_host_mesh
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.parallel.tensor import TensorParallel, vocab_embedding
from repro_torch.train.checkpoint import CheckpointManager, flatten_with_paths
from repro_torch.train.data import DataConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig

TOL = 2e-5                      # losses and norms (tests/test_kernels.py)
STATE_TOL = 1e-4                # gathered state, of each leaf's largest
METRICS = ("loss", "ce_loss", "z_loss", "aux_loss", "tokens", "grad_norm")
MOE = "deepseek-v3-16b"
DROPS = dict(capacity_factor=0.5)      # tokens dropped at these batches
SPAWN_TIMEOUT = 240.0
# The first step's gradients, gathered over both axes, against the single
# process's: each leaf within GRAD_TOL of its largest magnitude (the fp32
# tolerance; the largest difference read is 1.7e-6).  After 3 steps the
# moments are held on every element, the parameters on the elements whose
# first-step reference gradient is at least PARAM_FLOOR of the leaf's
# largest.  Over ``model`` the activations' gradients sum in another order
# than on one device, so an element whose gradient lies inside that
# rounding (up to 1.7e-6 of the leaf's largest) can flip sign, and AdamW's
# first update, lr times the gradient's sign, moves it by a whole lr step
# (up to 3.5e-4 of the leaf's largest read; 1.4e-5 above the floor).
GRAD_TOL = 2e-5
PARAM_FLOOR = 1e-5
# name: (arch, config overrides)
VARIANTS = {
    "llama": ("llama3.1-8b", {}),
    "kv_whole": ("llama3.1-8b", {"n_kv_heads": 1}),
    "heads_whole": ("llama3.1-8b", {"n_heads": 3, "n_kv_heads": 1}),
    "moe_drops": (MOE, {}),
}
# tests/test_multidevice.py:68's model, on its 2x4 mesh
MESH_2X4 = ("llama3.1-8b", dict(d_model=64, n_heads=4, n_kv_heads=4,
                                d_head=16, n_layers=2, vocab_size=512,
                                d_ff=128))
GRID = [(mesh, v, sp) for mesh in ((1, 2), (2, 2), (1, 4))
        for v in VARIANTS for sp in (True, False)]


def _name(mesh, variant, sp):
    return f"{mesh[0]}x{mesh[1]}-{variant}-{'sp' if sp else 'nosp'}"


def _model_config(arch, kw=None):
    cfg = get_reduced_config(arch).replace(compute_dtype="float32",
                                           **(kw or {}))
    return cfg if cfg.moe is None else \
        cfg.replace(moe=dataclasses.replace(cfg.moe, **DROPS))


def _config(job):
    return TrainerConfig(
        model=_model_config(job["arch"], job.get("kw")),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          grad_clip=1e9,
                          checkpoint_every=job.get("every", 0),
                          checkpoint_dir=str(job["dir"])),
        parallel=ParallelConfig(sequence_parallel=job.get("sp", True),
                                **job.get("parallel", {})),
        data=DataConfig(global_batch=8, seq_len=16))


# --------------------------------------------------------------------------- #
# The process groups
# --------------------------------------------------------------------------- #
def _worker(rank, world, ports, jobs, out):
    """One rank: every job's trainer on its mesh (each mesh made once), then
    the entry point's (which ends the process group); rank 0 saves the
    logs."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(ports[0]))
    torch.set_num_threads(1)
    meshes, logs = {}, {}
    for job in jobs:
        if job["name"] == "cli":
            continue
        m = job["model_parallel"]
        if m not in meshes:
            meshes[m] = make_host_mesh(model_parallel=m, device="cpu")
        tr = Trainer(_config(job), device="cpu", mesh=meshes[m])
        if job.get("prefetch") is False:
            tr.fsdp = FSDP(tr.model, meshes[m], tr.cfg.parallel, tr.device,
                           prefetch=False)
        tr.run(1)
        grads = _gathered_grads(tr)
        logs[job["name"]] = tr.run(job["steps"] - 1)    # the whole log
        tr.ckpt.wait()
        if rank == 0:
            logs[job["name"] + "/grads"] = grads
        if rank == 0:
            logs[job["name"] + "/mesh"] = dict(tr.fsdp.mesh_shape)
            logs[job["name"] + "/prefetch"] = dict(tr.fsdp.prefetch_stats)
    for job in jobs:
        if job["name"] != "cli":
            continue
        from repro_torch.launch import train as launch_train
        os.environ["MASTER_PORT"] = str(ports[1])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch_train.main(job["argv"])
        logs["cli"] = buf.getvalue()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save(logs, out)


def _gathered_grads(tr):
    """The step's gradient of every parameter leaf, gathered whole over
    ``data`` and ``model`` (key -> tensor; every rank takes part)."""
    from repro_torch.parallel.tensor import all_gather_dim
    out = {}
    for (key, t), (_, p) in zip(flatten_with_paths(tr.state.params),
                                flatten_with_paths(tr.fsdp.placements)):
        g = t.grad.detach()
        if p.dim >= 0:
            g = all_gather_dim(g, p.dim, tr.fsdp.group)
        if p.mdim >= 0:
            g = all_gather_dim(g, p.mdim, tr.fsdp.model_group)
        out[key] = g.clone()
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, jobs, out):
    """The group of ``world`` processes, once, with a deadline of its own."""
    ports = [_free_port() for _ in range(2)]
    ctx = mp.start_processes(_worker, args=(world, ports, jobs, str(out)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"world {world} did not finish in {SPAWN_TIMEOUT} s")
    return torch.load(out)


def _jax_state_checkpoint(directory, arch):
    """JAX's initial state of the fp32 reduced config, checkpointed at step
    0 (the start the port and JAX share); returns (model, rules, state)."""
    import jax
    from repro.configs import ParallelConfig as JParallelConfig
    from repro.configs import get_reduced_config as jax_reduced
    from repro.models import build_model as jax_build_model
    from repro.parallel.fsdp import init_train_state
    from repro.parallel.sharding import ShardingRules as JShardingRules
    from repro.train.checkpoint import CheckpointManager as JCheckpointManager
    cfg = jax_reduced(arch).replace(compute_dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **DROPS))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    model = jax_build_model(cfg)
    rules = JShardingRules(mesh, cfg, JParallelConfig())
    state = init_train_state(model, rules, JParallelConfig(), seed=0)
    JCheckpointManager(str(directory), async_write=False).save(0, state)
    return cfg, model, rules, state


CLI = ["--arch", "llama3.1-8b", "--reduced", "--lr", "3e-3", "--device",
       "cpu", "--global-batch", "8", "--seq-len", "64", "--steps", "30",
       "--checkpoint-every", "0", "--model-parallel", "2"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's logs and jobs, and the JAX side's states; world 2 also
    runs the entry point, world 4 the checkpoint and JAX jobs."""
    root = tmp_path_factory.mktemp("tp")
    resume = {"name": "resume", "arch": "llama3.1-8b", "model_parallel": 2,
              "dir": root / "single", "steps": 2}
    _single_trainer(dict(resume, every=2, steps=2))
    jax_side = {arch: _jax_state_checkpoint(root / f"jax-{arch}", arch)
                for arch in ("llama3.1-8b", MOE)}
    jobs = {2: [], 4: [], 8: []}
    for mesh, variant, sp in GRID:
        arch, kw = VARIANTS[variant]
        jobs[mesh[0] * mesh[1]].append({
            "name": _name(mesh, variant, sp), "arch": arch, "kw": kw,
            "sp": sp, "model_parallel": mesh[1], "steps": 3, "every": 3,
            "dir": root / _name(mesh, variant, sp)})
    jobs[8].append({"name": "2x4", "arch": MESH_2X4[0], "kw": MESH_2X4[1],
                    "model_parallel": 4, "steps": 3, "every": 3,
                    "dir": root / "2x4"})
    jobs[4] += [resume] + [
        {"name": f"jax-{arch}", "arch": arch, "model_parallel": 2,
         "steps": 3, "dir": root / f"jax-{arch}"} for arch in jax_side]
    for twin, (case, kw) in TWINS.items():
        base = next(j for j in jobs[4] if j["name"] == case)
        jobs[4].append(dict(base, name=twin, dir=root / twin, **kw))
    jobs[2].append({"name": "cli", "argv": CLI + [
        "--checkpoint-dir", str(root / "cli"), "--metrics-out",
        str(root / "cli.json")]})
    out = {w: (_spawn(w, js, root / f"w{w}.pt"), {j["name"]: j for j in js})
           for w, js in jobs.items()}
    out["jax"] = jax_side
    out["root"] = root
    return out


_SINGLE = {}


def _single_trainer(job):
    """The single-process trainer of ``job``'s model after its steps (one
    run per model and step count, shared by the cases)."""
    key = (job["arch"], tuple(sorted(job.get("kw", {}).items())),
           tuple(sorted(job.get("parallel", {}).items())),
           job["steps"], job.get("every", 0), str(job["dir"])
           if job.get("every") else "")
    if key not in _SINGLE:
        tr = Trainer(_config(job), device="cpu")
        tr.run(job["steps"])
        tr.ckpt.wait()
        _SINGLE[key] = tr
    return _SINGLE[key]


def _reference(job, tmp_path):
    return _single_trainer(dict(job, dir=tmp_path, every=0))


def _close(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), \
                f"{what} step {i} {k}: {g[k]} vs {w[k]}"


CASES = [_name(*c) for c in GRID] + ["2x4"]
# twins of (2, 2) cases: name -> (the case, what the twin changes):
# gathering in place (FSDP(prefetch=False)), and the ParallelConfig options
# the port now carries
LLAMA_2X2, MOE_2X2 = _name((2, 2), "llama", True), _name((2, 2),
                                                          "moe_drops", True)
TWINS = {
    LLAMA_2X2 + "-in-place": (LLAMA_2X2, {"prefetch": False}),
    MOE_2X2 + "-in-place": (MOE_2X2, {"prefetch": False}),
    LLAMA_2X2 + "-explicit-overlap": (
        LLAMA_2X2, {"parallel": {"explicit_overlap": True}}),
    LLAMA_2X2 + "-int8": (LLAMA_2X2,
                          {"parallel": {"grad_compression": "int8"}}),
}


@pytest.mark.parametrize("case", CASES)
def test_steps_match_single_process(worlds, case, tmp_path):
    world = 8 if case == "2x4" else \
        int(case[0]) * int(case[2])
    logs, jobs = worlds[world]
    job = jobs[case]
    want = _reference(job, tmp_path).metrics_log
    got = logs[case]
    assert [m["step"] for m in got] == [0, 1, 2]
    assert logs[case + "/mesh"] == {"data": world // job["model_parallel"],
                                    "model": job["model_parallel"]}
    _close(got, want, case)
    cfg = _model_config(job["arch"], job.get("kw"))
    rules = ShardingRules(logs[case + "/mesh"], cfg,
                          ParallelConfig(sequence_parallel=job.get("sp",
                                                                   True)))
    d = rules.describe()
    if "kv_whole" in case or case.startswith("1x4-llama"):
        assert d["tp_heads"] and not d["tp_kv_heads"]
    if "heads_whole" in case:
        assert not d["tp_heads"] and not d["tp_kv_heads"]
    if "moe" in case:                                   # EP, tokens dropped
        assert d["expert_parallel"]
        T = 8 * 16
        assert capacity(cfg, T) < T * cfg.moe.top_k / cfg.moe.n_experts
        assert all(w["aux_loss"] > 0 for w in want)
    assert d["sequence_parallel"] == job.get("sp", True)


def _relative(a, b, mask=None):
    """The largest |a - b| (over ``mask``) in units of b's largest."""
    a, b = a.detach().double(), b.detach().double()
    d = (a - b).abs() if mask is None else (a - b).abs()[mask]
    return float(d.max()) / max(float(b.abs().max()), 1e-30) \
        if d.numel() else 0.0


@pytest.mark.parametrize("case", CASES)
def test_first_step_gradients_match_single_process(worlds, case, tmp_path):
    """Every leaf's first-step gradient on the mesh, gathered over both
    axes, equals the single process's within GRAD_TOL of its largest."""
    world = 8 if case == "2x4" else int(case[0]) * int(case[2])
    logs, jobs = worlds[world]
    single = _single_trainer(dict(jobs[case], steps=1, every=0,
                                  dir=tmp_path))
    got = logs[case + "/grads"]
    want = flatten_with_paths(single.state.params)
    assert sorted(got) == [k for k, _ in want]
    for key, t in want:
        err = _relative(got[key], t.grad)
        assert err <= GRAD_TOL, f"{key}: {err:.3e} of the leaf's largest"


@pytest.mark.parametrize("case", CASES)
def test_gathered_state_matches_single_process(worlds, case, tmp_path):
    """The mesh's checkpoint at step 3 (each leaf gathered over both axes,
    written by rank 0 as it came) holds the single-process moments, and
    its parameters where the first-step reference gradient is at least
    PARAM_FLOOR of the leaf's largest."""
    world = 8 if case == "2x4" else int(case[0]) * int(case[2])
    _, jobs = worlds[world]
    job = jobs[case]
    single = _reference(job, tmp_path)
    like = Trainer(_config(dict(job, dir=tmp_path / "like", every=0)),
                   device="cpu")
    like.init_or_restore()
    CheckpointManager(str(job["dir"])).restore(like.state, 3)
    assert int(like.state.opt.step) == 3
    first = {k: t.grad.abs() for k, t in flatten_with_paths(
        _single_trainer(dict(job, steps=1, every=0, dir=tmp_path))
        .state.params)}
    for (key, a), b in zip(flatten_with_paths(like.state),
                           tree_leaves(single.state)):
        mask = None
        if key.startswith("params/"):
            g = first[key[len("params/"):]]
            mask = g >= PARAM_FLOOR * float(g.max())
        err = _relative(a, b, mask)
        assert err <= STATE_TOL, f"{key}: {err:.3e} of the leaf's largest"


@pytest.mark.parametrize("arch", ["llama3.1-8b", MOE])
def test_2x2_matches_jax_one_device(worlds, arch):
    """JAX's build_train_step on one device and the port on the (2, 2)
    mesh, from the same JAX-made initial state and the same batches: each
    step's loss and gradient norm within TOL."""
    import jax
    from repro.configs import ParallelConfig as JParallelConfig
    from repro.configs import TrainConfig as JTrainConfig
    from repro.parallel.fsdp import build_train_step
    from repro.train.data import DataConfig as JDataConfig
    from repro.train.data import SyntheticTokens as JSyntheticTokens
    cfg, model, rules, state = worlds["jax"][arch]
    step_fn, _ = build_train_step(
        model, JTrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_clip=1e9), rules,
        JParallelConfig())
    data = JSyntheticTokens(JDataConfig(global_batch=8, seq_len=16), cfg)
    want = []
    with rules.mesh:
        for step in range(3):
            batch = {k: jax.numpy.asarray(v)
                     for k, v in data.batch_at(step).items()}
            state, m = step_fn(state, batch)
            want.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    got = worlds[4][0][f"jax-{arch}"]
    assert [m["step"] for m in got] == [0, 1, 2]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), \
                f"step {i} {k}: port {g[k]} vs JAX {w[k]}"


def test_2x2_checkpoint_restores_in_one_process_and_in_jax(worlds):
    import jax
    from repro.configs import ParallelConfig as JParallelConfig
    from repro.parallel.fsdp import init_train_state
    from repro.train.checkpoint import CheckpointManager as JCheckpointManager
    job = worlds[4][1][_name((2, 2), "llama", True)]
    tr = Trainer(_config(dict(job, every=0)), device="cpu")
    tr.init_or_restore()                                 # one process
    assert tr.step == 3
    _, jmodel, jrules, _ = worlds["jax"]["llama3.1-8b"]
    like = jax.eval_shape(lambda: init_train_state(jmodel, jrules,
                                                   JParallelConfig()))
    restored, manifest = JCheckpointManager(str(job["dir"])).restore(like)
    assert manifest["step"] == 3
    jleaves = jax.tree_util.tree_leaves(restored)
    tleaves = list(tree_leaves(tr.state))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_single_process_checkpoint_resumes_at_2x2(worlds, tmp_path):
    """The (2, 2) mesh restored the single-process step-2 checkpoint (each
    rank its block over both axes) and trained steps 2 and 3 to the losses
    the single process reaches."""
    job = worlds[4][1]["resume"]
    want = _reference(dict(job, steps=4), tmp_path).metrics_log
    got = worlds[4][0]["resume"]
    assert [m["step"] for m in got] == [2, 3]
    _close(got, want[2:], "resumed at (2, 2)")


def test_entry_point_trains_tensor_parallel(worlds):
    """tests/test_integration.py's settings through launch.train.main with
    --model-parallel 2 at world 2: rank 0 prints the (1, 2) mesh, and the
    loss falls by at least 0.2 in 30 steps."""
    import json
    text = worlds[2][0]["cli"]
    log = json.loads((worlds["root"] / "cli.json").read_text())
    assert "mesh (data, model) = (1, 2) over 2 cpu processes" in text
    assert "world=2 step 29" in text
    assert [m["step"] for m in log] == list(range(30))
    assert log[-1]["loss"] < log[0]["loss"] - 0.2


def _checkpoint_arrays(job):
    with np.load(os.path.join(str(job["dir"]), "step_00000003",
                              "shard_0.npz")) as f:
        return {k: f[k] for k in f.files}


def _same_run(logs, jobs, a, b):
    """Two jobs' metrics, first-step gradients and state after 3 steps
    (every leaf) equal bit for bit."""
    assert logs[a] == logs[b]
    assert logs[a + "/grads"].keys() == logs[b + "/grads"].keys()
    for key, g in logs[a + "/grads"].items():
        assert torch.equal(g, logs[b + "/grads"][key]), key
    left, right = _checkpoint_arrays(jobs[a]), _checkpoint_arrays(jobs[b])
    assert left.keys() == right.keys()
    for key, v in left.items():
        np.testing.assert_array_equal(v, right[key], err_msg=key)


@pytest.mark.parametrize("case", [LLAMA_2X2, MOE_2X2])
def test_prefetch_equals_gathering_in_place_on_2x2(worlds, case):
    """On the (2, 2) mesh the data group's gathers run a layer ahead and
    its reduce-scatters in flight, the model group's sequence collectives
    where they were: the same sums in the same order as gathering in place
    (FSDP(prefetch=False)), so the metrics, the first step's gradients and
    the state after 3 steps equal bit for bit; 2(L - 1) layers gathered
    ahead a step, never more than one at a time."""
    logs, jobs = worlds[4]
    twin = case + "-in-place"
    _same_run(logs, jobs, case, twin)
    L = _model_config(jobs[case]["arch"]).n_layers
    assert logs[case + "/prefetch"] == {"layers": 2 * (L - 1),
                                        "most_ahead": 1}
    assert logs[twin + "/prefetch"] == {"layers": 0, "most_ahead": 0}


@pytest.mark.parametrize("option", ["explicit_overlap", "grad_compression"])
def test_carried_options_on_2x2(worlds, option, tmp_path):
    """On the (2, 2) mesh: ``explicit_overlap`` (read nowhere, as in JAX)
    trains the default step bit for bit; int8 compression trains, each
    step's metrics within TOL of one process with it, the error tree in
    the checkpoint under JAX's keys and finite."""
    logs, jobs = worlds[4]
    if option == "explicit_overlap":
        _same_run(logs, jobs, LLAMA_2X2, LLAMA_2X2 + "-explicit-overlap")
        return
    job = jobs[LLAMA_2X2 + "-int8"]
    _close(logs[job["name"]], _reference(job, tmp_path).metrics_log,
           job["name"])
    err = {k: v for k, v in _checkpoint_arrays(job).items()
           if k.startswith("err|")}
    assert {"err|embed", "err|g0|attn|wq"} <= set(err)
    assert all(np.isfinite(v).all() for v in err.values())
    assert any(v.any() for v in err.values())


# --------------------------------------------------------------------------- #
# Pieces, without processes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("H,KV,m", [(4, 2, 4), (4, 1, 2), (8, 2, 8),
                                    (12, 6, 4), (6, 2, 2)])
def test_split_heads_read_their_kv_heads(H, KV, m):
    """Attention over each rank's block of query heads (wq's columns, wo's
    rows) with wk and wv whole, summed over the ranks, equals attention
    over every head: local head j of rank r reads kv head
    ``(r * H/m + j) // (H/KV)``, also where a rank's heads straddle two
    kv groups (12/6 over 4)."""
    cfg = get_reduced_config("llama3.1-8b").replace(
        n_heads=H, n_kv_heads=KV, compute_dtype="float32")
    g = torch.Generator().manual_seed(0)
    D, d = cfg.head_dim, cfg.d_model
    p = {"wq": torch.randn(d, H * D, generator=g) / 8,
         "wk": torch.randn(d, KV * D, generator=g) / 8,
         "wv": torch.randn(d, KV * D, generator=g) / 8,
         "wo": torch.randn(H * D, d, generator=g) / 8}
    x = torch.randn(2, 12, d, generator=g)
    pos = torch.arange(12, dtype=torch.int32)
    want = attn.attention(cfg, p, x, pos)
    n = H // m
    got = sum(attn.attention(
        cfg, dict(p, wq=p["wq"][:, r * n * D:(r + 1) * n * D],
                  wo=p["wo"][r * n * D:(r + 1) * n * D]), x, pos,
        kv_index=attn.local_kv_heads(cfg, n, r)) for r in range(m))
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_lookup_sums_to_the_lookup(m):
    g = torch.Generator().manual_seed(1)
    table = torch.randn(64, 8, generator=g)
    tokens = torch.randint(0, 64, (3, 5), generator=g)
    parts = [vocab_embedding(table.chunk(m)[r], tokens,
                             TensorParallel(None, m, r, True))
             for r in range(m)]
    assert torch.equal(sum(parts), table[tokens])
    assert all(int((p != 0).any(-1).sum()) < tokens.numel() for p in parts)


def test_constrain_keeps_the_ranks_block_of_the_sequence():
    """Under sequence parallelism ``shard_residual`` keeps this model
    rank's contiguous S/m rows of a stream whole over ``model`` (the chunk
    JAX's NamedSharding gives it), leaves the (already local) batch axis
    and a sequence the axis does not divide as they are."""
    shape = {"data": 2, "model": 4}
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    assert act.shard_residual(x) is x                  # no rules installed
    rules = {"act_batch": ("data",), "act_seq": ("model",)}
    for r in range(4):
        with act.activation_sharding(shape, rules, {"data": 1, "model": r}):
            assert act.seq_extent() == 4 and act.data_extent() == 2
            assert torch.equal(act.shard_residual(x), x[:, 2 * r:2 * r + 2])
            assert act.shard_residual(x[:, :6]).shape == (2, 6, 3)
    with act.activation_sharding(shape, dict(rules, act_seq=())):
        assert act.seq_extent() == 1
        assert act.shard_residual(x) is x


def test_sharded_save_writes_on_its_thread_a_few_leaves_behind(
        tmp_path, monkeypatch):
    """``save_leaves`` hands the leaves to the writer thread as they come,
    never more than a few ahead of the file, and the checkpoint restores."""
    produced, ahead = [], []
    write_array = np.lib.format.write_array

    def slow_write(f, arr, **kw):
        ahead.append(len(produced) - 1 - int(arr.flat[0]))
        time.sleep(0.005)
        write_array(f, arr, **kw)
    monkeypatch.setattr(np.lib.format, "write_array", slow_write)

    def leaves():
        for i in range(12):
            produced.append(i)
            yield f"w/{i:02d}", torch.full((3,), float(i))
    cm = CheckpointManager(str(tmp_path))
    cm.save_leaves(5, leaves(), extra={"model": "x"})
    cm.wait()
    assert len(ahead) == 12
    assert max(ahead) <= CheckpointManager.LEAVES_IN_FLIGHT + 2
    like = {"w": {f"{i:02d}": torch.zeros(3) for i in range(12)}}
    _, manifest = cm.restore(like)
    assert manifest["step"] == 5 and manifest["extra"] == {"model": "x"}
    assert all(float(like["w"][f"{i:02d}"][0]) == i for i in range(12))


# --------------------------------------------------------------------------- #
# What stays out, and no fallback
# --------------------------------------------------------------------------- #
class _Mesh:
    mesh_dim_names = ("data", "model")

    def __init__(self, data, model):
        self.shape = (data, model)

    def size(self, i):
        return self.shape[i]


def _raises_cache_shardings():
    cfg = get_reduced_config("llama3.1-8b")
    ShardingRules({"data": 1, "model": 2}, cfg,
                  ParallelConfig()).cache_shardings({})


def _raises_tp_experts():
    FSDP(build_model(get_reduced_config(MOE)), _Mesh(1, 8),
         ParallelConfig(), "cpu")                      # 4 experts over 8


def _raises_ffn_not_divided():
    cfg = get_reduced_config("llama3.1-8b").replace(d_ff=100)
    FSDP(build_model(cfg), _Mesh(1, 8), ParallelConfig(), "cpu")


def _raises_extra(option):
    def run():
        cfg = _config({"arch": "llama3.1-8b", "dir": "unused"})
        cfg.parallel = ParallelConfig(**option)
        FSDP(build_model(cfg.model), _Mesh(1, 2), cfg.parallel, "cpu")
    return run


STAYS_OUT = {
    "cache_shardings": (_raises_cache_shardings, "item 8c"),
    "tp_experts": (_raises_tp_experts, "item 13b"),
    "ffn_not_divided": (_raises_ffn_not_divided, "item 13b"),
    "multi_pod": (_raises_extra({"multi_pod": True}), "item 19b"),
    "remat_dots": (_raises_extra({"remat_policy": "dots"}), "item 8d"),
}


@pytest.mark.parametrize("what", list(STAYS_OUT))
def test_what_stays_out_raises_naming_roadmap(what):
    run, item = STAYS_OUT[what]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        run()


def test_model_parallel_without_torchrun_raises(monkeypatch, tmp_path):
    from repro_torch.launch import train as launch_train
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--reduced", "--device", "cpu", "--steps", "1",
                           "--checkpoint-dir", str(tmp_path),
                           "--model-parallel", "2"])


def test_world_the_model_axis_does_not_divide_raises(monkeypatch):
    """Before joining any group: no mesh of another shape is made."""
    for k, v in dict(RANK="0", WORLD_SIZE="3", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="does not divide the world of 3"):
        make_host_mesh(model_parallel=2, device="cpu")
    assert not torch.distributed.is_initialized()
