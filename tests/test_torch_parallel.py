"""The port's FSDP (ZeRO-3 over the ``data`` axis), on the CPU over gloo.

* ``ShardingRules`` against the JAX package's: every leaf's spec of every
  arch the port registers, ``describe()`` and ``activation_rules()``, on six
  meshes (the JAX rules read only ``mesh.shape`` there, so a stand-in with a
  ``shape`` dict serves).
* Worlds 2 and 4 of processes (``torch.multiprocessing``, gloo), each group
  spawned once, against the single-process ``Trainer`` at the same seed on
  reduced fp32 llama3.1-8b: each step's loss, CE, z-loss, token count and
  gradient norm within 2e-5 (the JAX package's fp32 tolerance,
  ``tests/test_kernels.py``), also for a global batch the world does not
  divide, for labels with uneven ignored counts per rank and for an active
  clip; the gathered parameters and moments after 3 steps within 1e-4 of
  each leaf's largest magnitude.  Why 1e-4: the gradients are fp32 sums in
  another order (~1e-7 relative), and AdamW divides each element's update
  by that element's own gradient scale, so an element whose gradient is
  near zero moves by up to ``lr`` (1e-3) times its relative difference;
  the worst leaf read 5.4e-6.  A wrong shard moves parameters (~0.3) by
  ``lr``, 3e-3 of the leaf, and a lost or doubled reduction moves the
  moments by 50-300%.
* The same for reduced fp32 deepseek-v3-16b (MoE) with capacity factor
  0.5, so that tokens are dropped: split rows (the global dispatch: the
  global capacity and positions, the aux from the global counts) and rows
  the world does not divide (each rank routes the whole batch); the aux
  loss too.
* The port at world 2 against JAX's ``build_train_step`` on one device,
  from the same (JAX-made) initial state, for llama3.1-8b and for
  deepseek-v3-16b with drops.
* Checkpoints across worlds: a world-2 checkpoint restores in a
  single-process torch ``Trainer`` and through the JAX
  ``CheckpointManager``; a single-process checkpoint restores at world 2
  and training continues to the single-process losses.
* ``python -m repro_torch.launch.train``'s ``main`` under a torchrun-shaped
  environment at world 2 (the settings of tests/test_integration.py): the
  loss falls by at least 0.2 in 30 steps, a restart resumes at step 30 and
  the gpu-red hook moves the caps.
* The overlap: FSDP's default path (each layer's gathers issued a layer
  ahead, its reduce-scatters left in flight) against gathering in place
  (``FSDP(prefetch=False)``), llama and MoE with drops at worlds 2 and 4:
  every step's metrics, and every leaf of the state after 3 steps, equal
  bit for bit; the gathers run 2(L - 1) layers ahead a step, never more
  than one layer at a time.
* int8 gradient compression at world 2 against one process with it: each
  step's metrics within 2e-5, and the first step's dequantized gradients
  and error (gathered) within 2e-5 of the leaf's largest |g + e|, except a
  flip of exactly one quantum in at most 1% of a leaf's elements
  (``tests/test_torch_collectives.py`` says why).
* The options the port does not carry raise, naming ROADMAP.md (the
  layouts over ``model`` it does not carry too); ``explicit_overlap``
  trains the default step and int8 compression trains; no fallback from
  CUDA to gloo.
"""
import contextlib
import dataclasses
import io
import os
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build_model
from repro.parallel.fsdp import build_train_step as jax_build_train_step
from repro.parallel.fsdp import init_train_state as jax_init_train_state
from repro.parallel.sharding import ShardingRules as JShardingRules
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticTokens as JSyntheticTokens
from repro_torch.configs import ParallelConfig, TrainConfig, get_config
from repro_torch.configs import get_reduced_config
from repro_torch.configs.registry import _ARCH_MODULES
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.models.moe import capacity
from repro_torch.parallel.fsdp import FSDP
from repro_torch.parallel.mesh import make_host_mesh
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.train.checkpoint import CheckpointManager, flatten_with_paths
from repro_torch.train.data import DataConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig
from test_torch_collectives import quantum_close

TOL = 2e-5                      # losses and norms (tests/test_kernels.py)
STATE_TOL = 1e-4                # gathered state, of each leaf's largest
METRICS = ("loss", "ce_loss", "z_loss", "aux_loss", "tokens", "grad_norm")
MOE = "deepseek-v3-16b"
DROPS = dict(capacity_factor=0.5)      # tokens dropped at these batches
SPAWN_TIMEOUT = 240.0


# --------------------------------------------------------------------------- #
# Rules against JAX
# --------------------------------------------------------------------------- #
class FakeMesh:
    """Duck-typed mesh: the JAX rules read only ``.shape`` here."""

    def __init__(self, shape):
        self.shape = shape


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2),
                                  (2, 4)], ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_sharding_rules_match_jax(arch, mesh):
    shape = {"data": mesh[0], "model": mesh[1]}
    jr = JShardingRules(FakeMesh(shape), jax_get_config(arch),
                        JParallelConfig())
    tr = ShardingRules(shape, get_config(arch), ParallelConfig())
    jspecs = dict(_spec_leaves(jax_build_model(jax_get_config(arch))
                               .param_specs()))
    tspecs = dict(_spec_leaves(build_model(get_config(arch)).param_specs()))
    assert jspecs.keys() == tspecs.keys()
    for key, js in jspecs.items():
        ts = tspecs[key]
        assert tuple(ts.shape) == tuple(js.shape), key
        assert tr.spec_for(ts.axes, ts.shape) == \
            tuple(jr.spec_for(js.axes, js.shape)), key
    assert tr.describe() == jr.describe()
    assert tr.activation_rules() == jr.activation_rules()
    assert tr.axis_map == jr.axis_map


# --------------------------------------------------------------------------- #
# The process groups
# --------------------------------------------------------------------------- #
class UnevenLabels:
    """The synthetic stream with most labels of the first half of the rows
    ignored: ranks hold very different counts of valid tokens."""

    def __init__(self, data):
        self.data = data

    def batch_at(self, step):
        b = self.data.batch_at(step)
        b["labels"][: b["labels"].shape[0] // 2, 2:] = -100
        return b


def _model_config(arch):
    cfg = get_reduced_config(arch).replace(compute_dtype="float32")
    return cfg if cfg.moe is None else \
        cfg.replace(moe=dataclasses.replace(cfg.moe, **DROPS))


def _config(ckdir, *, batch=8, seq=16, clip=1e9, every=0,
            arch="llama3.1-8b", parallel=None):
    return TrainerConfig(
        model=_model_config(arch),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          grad_clip=clip, checkpoint_every=every,
                          checkpoint_dir=str(ckdir)),
        parallel=ParallelConfig(**(parallel or {})),
        data=DataConfig(global_batch=batch, seq_len=seq))


def _trainer(job, **kw):
    tr = Trainer(_config(job["dir"], **job.get("cfg", {})), device="cpu",
                 **kw)
    if job.get("uneven"):
        tr.data = UnevenLabels(tr.data)
    return tr


def _round_trip(tr):
    """The step's dequantized gradient and the new error of every leaf,
    gathered whole over ``data`` (key -> tensor; every rank takes part)."""
    from repro_torch.parallel.tensor import all_gather_dim
    out = {}
    for (key, t), (_, e), p in zip(flatten_with_paths(tr.state.params),
                                   flatten_with_paths(tr.state.err),
                                   tree_leaves(tr.fsdp.placements)):
        for name, v in (("grad", t.grad.detach()), ("err", e)):
            out[f"{name}/{key}"] = (v.clone() if p.dim < 0 else
                                    all_gather_dim(v, p.dim, tr.fsdp.group))
    return out


def _worker(rank, world, ports, jobs, out):
    """One rank: every job's trainer on the shared mesh, then the entry
    point's (which ends the process group); rank 0 saves the logs."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(ports[0]))
    torch.set_num_threads(1)
    mesh = make_host_mesh(device="cpu")
    logs = {}
    for job in jobs:
        if job["name"] == "cli":
            continue
        tr = _trainer(job, mesh=mesh)
        if job.get("prefetch") is False:
            tr.fsdp = FSDP(tr.model, mesh, tr.cfg.parallel, tr.device,
                           prefetch=False)
        if job.get("round_trip"):
            tr.run(1)
            logs[job["name"] + "/round_trip"] = _round_trip(tr)
        logs[job["name"]] = tr.run(job["steps"] - tr.step)
        logs[job["name"] + "/prefetch"] = dict(tr.fsdp.prefetch_stats)
        tr.ckpt.wait()
    for job in jobs:
        if job["name"] != "cli":
            continue
        from repro_torch.launch import train as launch_train
        texts = []
        for port, argv in zip(ports[1:], job["argv"]):
            os.environ["MASTER_PORT"] = str(port)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                launch_train.main(argv)
            texts.append(buf.getvalue())
        logs["cli"] = texts
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save(logs, out)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, jobs, out):
    """The group of ``world`` processes, once, with a deadline of its own."""
    ports = [_free_port() for _ in range(3)]
    ctx = mp.start_processes(_worker, args=(world, ports, jobs, str(out)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"world {world} did not finish in {SPAWN_TIMEOUT} s")
    return torch.load(out)


def _single(job, steps=None):
    tr = _trainer(job)
    log = tr.run(steps or job["steps"])
    tr.ckpt.wait()
    return tr, log


def _jax_config(arch):
    cfg = jax_reduced(arch).replace(compute_dtype="float32")
    return cfg if cfg.moe is None else \
        cfg.replace(moe=dataclasses.replace(cfg.moe, **DROPS))


def _jax_state_checkpoint(directory, arch="llama3.1-8b"):
    """JAX's initial state of the fp32 reduced config, checkpointed at step
    0 (the start the port and JAX share); returns (model, rules, state)."""
    cfg = _jax_config(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    model = jax_build_model(cfg)
    rules = JShardingRules(mesh, cfg, JParallelConfig())
    state = jax_init_train_state(model, rules, JParallelConfig(), seed=0)
    JCheckpointManager(str(directory), async_write=False).save(0, state)
    return model, rules, state


CASES = {   # name: (trainer settings, uneven labels)
    "base": ({}, False),
    "odd_batch": ({"batch": 3}, False),
    "uneven_ignore": ({}, True),
    "active_clip": ({"clip": 1.0}, False),
    "moe_drops": ({"arch": MOE}, False),
    "moe_odd_batch": ({"arch": MOE, "batch": 3}, False),
}
ODD = ("odd_batch", "moe_odd_batch")
# each case's twin that gathers in place (FSDP(prefetch=False))
IN_PLACE = {"base": "base_in_place", "moe_drops": "moe_in_place"}
INT8 = {"grad_compression": "int8"}
CLI = ["--arch", "llama3.1-8b", "--reduced", "--lr", "3e-3", "--device",
       "cpu", "--global-batch", "8", "--seq-len", "64", "--checkpoint-every",
       "15", "--use-case", "gpu-red"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's logs, its jobs, and the JAX side's; world 2 also runs
    the checkpoint, JAX and entry-point jobs."""
    root = tmp_path_factory.mktemp("fsdp")
    # the single-process checkpoint (step 2) that world 2 resumes from
    resume = {"name": "resume", "dir": root / "single", "steps": 2}
    _single(dict(resume, cfg={"every": 2}))
    resume_int8 = {"name": "resume_int8", "dir": root / "single_int8",
                   "steps": 2, "cfg": {"parallel": INT8}}
    _single(dict(resume_int8, cfg={"every": 2, "parallel": INT8}))
    jmodel, jrules, jstate = _jax_state_checkpoint(root / "jax")
    jmoe = _jax_state_checkpoint(root / "jax_moe", MOE)
    out = {}
    for world in (2, 4):
        jobs = []
        for name, (cfg, uneven) in CASES.items():
            if world == 4 and name == "active_clip":
                continue
            if name in ODD:
                cfg = dict(cfg, batch=3 if world == 2 else 6)
            jobs.append({"name": name, "dir": root / f"w{world}-{name}",
                         "steps": 3, "uneven": uneven,
                         "cfg": dict(cfg, every=3 if name in IN_PLACE
                                     else 0)})
        jobs += [{"name": twin, "dir": root / f"w{world}-{twin}", "steps": 3,
                  "prefetch": False, "cfg": dict(CASES[name][0], every=3)}
                 for name, twin in IN_PLACE.items()]
        if world == 2:
            jobs += [{"name": "int8", "dir": root / "w2-int8", "steps": 3,
                      "round_trip": True, "cfg": {"parallel": INT8}},
                     resume_int8]
            jobs += [resume, {"name": "jax", "dir": root / "jax", "steps": 3},
                     {"name": "moe_jax", "dir": root / "jax_moe", "steps": 3,
                      "cfg": {"arch": MOE}},
                     {"name": "cli", "argv": [
                         CLI + ["--steps", "30", "--checkpoint-dir",
                                str(root / "cli"), "--metrics-out",
                                str(root / "cli.json")],
                         CLI + ["--steps", "3", "--checkpoint-dir",
                                str(root / "cli")]]}]
        out[world] = (_spawn(world, jobs, root / f"w{world}.pt"),
                      {j["name"]: j for j in jobs})
    out["jax"] = (jmodel, jrules, jstate)
    out["moe_jax"] = jmoe
    out["root"] = root
    return out


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), \
                f"{what} step {i} {k}: {g[k]} vs {w[k]}"


@pytest.mark.parametrize("world,case", [(2, c) for c in CASES]
                         + [(4, c) for c in CASES if c != "active_clip"])
def test_fsdp_steps_match_single_process(worlds, world, case, tmp_path):
    logs, jobs = worlds[world]
    job = dict(jobs[case], dir=tmp_path, cfg=dict(jobs[case]["cfg"], every=0))
    _, want = _single(job)
    got = logs[case]
    assert [m["step"] for m in got] == [0, 1, 2]
    _close(got, want, f"world {world} {case}")
    if case == "active_clip":
        assert all(m["grad_norm"] > 1.0 for m in want)   # the clip bites
    if case == "uneven_ignore":
        assert want[0]["tokens"] < 8 * 15 * 0.6          # half mostly masked
    if case in ODD:
        assert job["cfg"]["batch"] % world                # replicated rows
    if case.startswith("moe"):                            # tokens dropped
        cfg, m = _model_config(MOE), _model_config(MOE).moe
        T = job["cfg"].get("batch", 8) * 16
        assert capacity(cfg, T) < T * m.top_k / m.n_experts
        assert all(w["aux_loss"] > 0 for w in want)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_gathered_state_matches_single_process(worlds, world, tmp_path):
    """The world's checkpoint at step 3 (gathered leaf by leaf by rank 0)
    holds the single-process parameters and moments."""
    _, jobs = worlds[world]
    single, _ = _single(dict(jobs["base"], dir=tmp_path,
                             cfg=dict(jobs["base"]["cfg"], every=0)))
    like = _trainer(dict(jobs["base"], dir=tmp_path / "like"))
    like.init_or_restore()
    CheckpointManager(str(jobs["base"]["dir"])).restore(like.state, 3)
    assert int(like.state.opt.step) == 3
    for (key, a), b in zip(flatten_with_paths(like.state),
                           tree_leaves(single.state)):
        a, b = a.detach().double(), b.detach().double()
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= STATE_TOL, f"{key}: {err:.3e} of the leaf's largest"


def test_world2_checkpoint_restores_in_one_process_and_in_jax(worlds):
    logs, jobs = worlds[2]
    ckdir = str(jobs["base"]["dir"])
    tr = _trainer(dict(jobs["base"], cfg=dict(jobs["base"]["cfg"], every=0)))
    tr.init_or_restore()                                 # one process
    assert tr.step == 3
    jmodel, jrules, _ = worlds["jax"]
    like = jax.eval_shape(lambda: jax_init_train_state(
        jmodel, jrules, JParallelConfig()))
    restored, manifest = JCheckpointManager(ckdir).restore(like)
    assert manifest["step"] == 3
    jleaves = jax.tree_util.tree_leaves(restored)
    tleaves = list(tree_leaves(tr.state))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_single_process_checkpoint_resumes_at_world2(worlds, tmp_path):
    """World 2 restored the single-process step-2 checkpoint and trained
    steps 2 and 3 to the losses the single process reaches."""
    logs, jobs = worlds[2]
    _, want = _single(dict(jobs["resume"], dir=tmp_path), steps=4)
    got = logs["resume"]
    assert [m["step"] for m in got] == [2, 3]
    _close(got, want[2:], "resumed at world 2")


def _jax_steps(model, rules, state, cfg, steps=3):
    """Each step's loss and gradient norm of JAX's build_train_step on one
    device, from ``state``, on the synthetic batches."""
    step_fn, _ = jax_build_train_step(
        model, JTrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_clip=1e9), rules, JParallelConfig())
    data = JSyntheticTokens(JDataConfig(global_batch=8, seq_len=16), cfg)
    want = []
    with rules.mesh:
        for step in range(steps):
            batch = {k: jax.numpy.asarray(v)
                     for k, v in data.batch_at(step).items()}
            state, m = step_fn(state, batch)
            want.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return want


def test_moe_world2_matches_jax_one_device(worlds):
    """test_world2_matches_jax_one_device for reduced deepseek-v3-16b with
    tokens dropped: the port's global dispatch over two ranks against JAX's
    global-capacity dispatch on one device."""
    jmodel, jrules, state = worlds["moe_jax"]
    want = _jax_steps(jmodel, jrules, state, _jax_config(MOE))
    got = worlds[2][0]["moe_jax"]
    assert [m["step"] for m in got] == [0, 1, 2]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), \
                f"step {i} {k}: port {g[k]} vs JAX {w[k]}"


def test_world2_matches_jax_one_device(worlds):
    """JAX's build_train_step on one device and the port at world 2, from
    the same initial state and batches: each step's loss within TOL."""
    jmodel, jrules, state = worlds["jax"]
    cfg = jax_reduced("llama3.1-8b").replace(compute_dtype="float32")
    step_fn, _ = jax_build_train_step(
        jmodel, JTrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                             grad_clip=1e9), jrules, JParallelConfig())
    data = JSyntheticTokens(JDataConfig(global_batch=8, seq_len=16), cfg)
    want = []
    with jrules.mesh:
        for step in range(3):
            batch = {k: jax.numpy.asarray(v)
                     for k, v in data.batch_at(step).items()}
            state, m = step_fn(state, batch)
            want.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    got = worlds[2][0]["jax"]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), \
                f"step {i} {k}: port {g[k]} vs JAX {w[k]}"


def test_entry_point_trains_sharded_and_resumes(worlds):
    """tests/test_integration.py's settings through launch.train.main at
    world 2: the loss falls by 0.2 in 30 steps, the restart resumes at step
    30, the gpu-red hook moves the caps; only rank 0 prints."""
    import json
    first, again = worlds[2][0]["cli"]
    log = json.loads((worlds["root"] / "cli.json").read_text())
    assert [m["step"] for m in log] == list(range(30))
    assert log[-1]["loss"] < log[0]["loss"] - 0.2
    assert "world=2 step 29" in first
    caps = [float(x) for x in first.split("converged caps = [")[1]
            .split("]")[0].split(",")]
    assert len(set(caps)) > 1                 # the manager moved the caps
    assert "world=2 step 32" in again         # resumed at step 30
    assert sorted(os.listdir(worlds["root"] / "cli")) == \
        ["LATEST", "step_00000015", "step_00000030"]


# --------------------------------------------------------------------------- #
# The overlap and int8 compression over the gloo worlds
# --------------------------------------------------------------------------- #
def _checkpoint_arrays(directory, step=3):
    with np.load(os.path.join(directory, f"step_{step:08d}",
                              "shard_0.npz")) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("world,case", [(w, c) for w in (2, 4)
                                        for c in IN_PLACE])
def test_prefetch_equals_gathering_in_place(worlds, world, case):
    """The default path (gathers a layer ahead, reduce-scatters in flight)
    and FSDP(prefetch=False) take the same sums in the same order: every
    step's metrics and every leaf of the state after 3 steps (the
    parameters, both moments) equal bit for bit.  The default path gathered
    2(L - 1) layers ahead a step (the forward's and the recompute's),
    never more than one at a time; gathering in place, none."""
    logs, jobs = worlds[world]
    twin = IN_PLACE[case]
    assert logs[case] == logs[twin]
    ahead, in_place = (_checkpoint_arrays(jobs[n]["dir"]) for n in (case,
                                                                   twin))
    assert ahead.keys() == in_place.keys()
    assert {"params|embed", "opt|exp_avg|g0|attn|wq",
            "opt|exp_avg_sq|g0|ffn|wd"} <= set(ahead)
    for key, a in ahead.items():
        np.testing.assert_array_equal(a, in_place[key], err_msg=key)
    L = _model_config(jobs[case]["cfg"].get("arch", "llama3.1-8b")).n_layers
    assert logs[case + "/prefetch"] == {"layers": 2 * (L - 1),
                                        "most_ahead": 1}
    assert logs[twin + "/prefetch"] == {"layers": 0, "most_ahead": 0}


def _int8_job(job, tmp_path):
    return dict(job, dir=tmp_path, cfg=dict(job["cfg"], every=0))


def test_int8_world2_matches_one_process(worlds, tmp_path):
    """int8 compression sharded over two ranks (each leaf split along its
    last axis quantized against the whole slice's largest magnitude)
    against one process: each step's metrics within TOL; the first step,
    taken from the same state, its dequantized gradients and error within
    TOL of the leaf's largest |g + e| but for one-quantum flips."""
    logs, jobs = worlds[2]
    tr = _trainer(_int8_job(jobs["int8"], tmp_path))
    tr.run(1)
    got = logs["int8/round_trip"]
    for key, t in flatten_with_paths(tr.state.params):
        deq, err = t.grad.numpy(), dict(flatten_with_paths(
            tr.state.err))[key].numpy()
        x = np.abs(deq.astype(np.float64) + err)     # |g + e| of the step
        scale = np.maximum(x.max(-1, keepdims=True), 1e-12) / 127.0
        for name, want in (("grad", deq), ("err", err)):
            quantum_close(got[f"{name}/{key}"].numpy(), want, scale,
                          float(x.max()), f"{name} {key}")
    tr.run(2)
    _close(logs["int8"], tr.metrics_log, "int8 world 2")


def test_single_process_int8_checkpoint_resumes_at_world2(worlds,
                                                          tmp_path):
    """World 2 restored a one-process int8 checkpoint (step 2), each rank
    its shard of the parameters, both moments and the error, and trained
    steps 2 and 3 to the one process's metrics."""
    logs, jobs = worlds[2]
    _, want = _single(dict(jobs["resume_int8"], dir=tmp_path), steps=4)
    got = logs["resume_int8"]
    assert [m["step"] for m in got] == [2, 3]
    _close(got, want[2:], "int8 resumed at world 2")


# --------------------------------------------------------------------------- #
# What this slice refuses, and what it now carries
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("option", [{"multi_pod": True},
                                    {"remat_policy": "dots"}])
def test_uncarried_parallel_options_raise(option, tmp_path):
    cfg = _config(tmp_path)
    cfg.parallel = ParallelConfig(**option)
    item = "item 19b" if "multi_pod" in option else "item 8d"
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        Trainer(cfg, device="cpu")


def test_explicit_overlap_trains_the_default_step(tmp_path):
    """``explicit_overlap`` is read nowhere, as in the JAX package (the
    overlap is the default path): the same metrics and state bit for
    bit."""
    runs = []
    for overlap in (False, True):
        tr = _trainer({"dir": tmp_path / str(overlap),
                       "cfg": {"parallel": {"explicit_overlap": overlap}}})
        runs.append((tr.run(3), flatten_with_paths(tr.state)))
    (log_a, state_a), (log_b, state_b) = runs
    assert log_a == log_b
    assert [k for k, _ in state_a] == [k for k, _ in state_b]
    for (key, a), (_, b) in zip(state_a, state_b):
        assert torch.equal(a, b), key


def test_int8_compression_trains(tmp_path):
    """int8 compression trains: each step's gradients are whole multiples
    (at most 127) of their slice's scale, the error carried is finite and
    at most half a quantum, and the state holds the error tree under
    JAX's keys."""
    tr = _trainer({"dir": tmp_path, "cfg": {"parallel": INT8}})
    for _ in range(3):
        tr.run(1)
        for (key, p), (_, e) in zip(flatten_with_paths(tr.state.params),
                                    flatten_with_paths(tr.state.err)):
            g, e = p.grad.double(), e.double()
            scale = (g + e).abs().amax(-1, keepdim=True).clamp_min(
                1e-12) / 127
            q = g / scale
            assert float((q - q.round()).abs().max()) <= 1e-4, key
            assert float(q.abs().max()) <= 127 + 1e-4, key
            assert bool(torch.isfinite(e).all()), key
            assert bool((e.abs() <= scale * (0.5 + TOL)).all()), key
    assert np.isfinite([m["loss"] for m in tr.metrics_log]).all()
    assert "err/g0/attn/wq" in dict(flatten_with_paths(tr.state))


def test_unknown_grad_compression_raises(tmp_path):
    cfg = _config(tmp_path)
    cfg.parallel = ParallelConfig(grad_compression="int4")
    with pytest.raises(ValueError, match="int4"):
        Trainer(cfg, device="cpu")


class _MeshShape:
    mesh_dim_names = ("data", "model")

    def size(self, i):
        return (1, 3)[i]


def test_model_axis_raises_naming_the_roadmap_item():
    """The layouts over ``model`` the port does not carry raise, naming
    ROADMAP.md: experts the axis does not divide (the TP-expert layout),
    and serving over it (JAX's ``cache_shardings``)."""
    model = build_model(get_reduced_config(MOE))        # 4 experts over 3
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 13b"):
        FSDP(model, _MeshShape(), ParallelConfig(), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 8c"):
        ShardingRules({"data": 1, "model": 2},
                      get_reduced_config("llama3.1-8b"),
                      ParallelConfig()).cache_shardings({})


def test_mesh_on_cuda_has_no_fallback(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check needs a host without it")
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        make_host_mesh(device="cpu")
