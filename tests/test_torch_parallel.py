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
* The options the port does not carry raise, naming ROADMAP.md (the
  layouts over ``model`` it does not carry too); no fallback from CUDA to
  gloo.
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
            arch="llama3.1-8b"):
    return TrainerConfig(
        model=_model_config(arch),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          grad_clip=clip, checkpoint_every=every,
                          checkpoint_dir=str(ckdir)),
        data=DataConfig(global_batch=batch, seq_len=seq))


def _trainer(job, **kw):
    tr = Trainer(_config(job["dir"], **job.get("cfg", {})), device="cpu",
                 **kw)
    if job.get("uneven"):
        tr.data = UnevenLabels(tr.data)
    return tr


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
        logs[job["name"]] = tr.run(job["steps"])
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
                         "cfg": dict(cfg, every=3 if name == "base" else 0)})
        if world == 2:
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
# What this slice refuses
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("option", [{"multi_pod": True},
                                    {"explicit_overlap": True},
                                    {"grad_compression": "int8"},
                                    {"remat_policy": "dots"}])
def test_uncarried_parallel_options_raise(option, tmp_path):
    cfg = _config(tmp_path)
    cfg.parallel = ParallelConfig(**option)
    with pytest.raises(NotImplementedError, match="ROADMAP.md|'nothing'"):
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
