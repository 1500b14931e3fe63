"""The port's trainer, checkpoints and co-simulation hook, on the CPU.

Against the JAX package: a checkpoint the torch ``Trainer`` writes has the
keys, shapes and dtypes of the one the JAX ``Trainer`` writes for the same
configuration, and each restores through the other's ``CheckpointManager``
bit for bit; the port's copies of ``NodeSim``, ``SimBackend`` and
``PowerManager`` driven by ``LitSiliconHook`` give ``repro.core``'s
histories, metrics and caps float for float (numpy on both sides, the same
RNG streams).  Mirrors of ``tests/test_integration.py``: the loss falls by
at least 0.2 in 30 steps, a restart resumes at step 30, and the hook moves
the caps.  MoE and RWKV6 models are refused, naming ROADMAP.md.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_reduced
from repro.core.manager import ManagerConfig as JManagerConfig
from repro.parallel.fsdp import init_train_state as jax_init_train_state
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.data import DataConfig as JDataConfig
from repro.train.train_loop import LitSiliconHook as JLitSiliconHook
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import TrainConfig, get_config, get_reduced_config
from repro_torch.core.manager import ManagerConfig
from repro_torch.models.common import tree_leaves
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig
from repro_torch.train.train_loop import LitSiliconHook, Trainer, TrainerConfig

DATA = dict(global_batch=4, seq_len=16)


def _jax_trainer(ckdir, steps=2):
    tc = JTrainerConfig(
        model=jax_reduced("llama3.1-8b"),
        train=JTrainConfig(lr=3e-3, warmup_steps=1, total_steps=10,
                           checkpoint_every=steps, checkpoint_dir=ckdir),
        parallel=ParallelConfig(), data=JDataConfig(**DATA))
    return JTrainer(tc)


def _torch_config(ckdir, steps=2):
    return TrainerConfig(
        model=get_reduced_config("llama3.1-8b"),
        train=TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10,
                          checkpoint_every=steps, checkpoint_dir=ckdir),
        data=DataConfig(**DATA))


def _manifest(ckdir, step):
    with open(os.path.join(ckdir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_layout_and_cross_restore(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jt = _jax_trainer(jdir)
    jt.run(2)
    jt.ckpt.wait()
    tt = Trainer(_torch_config(tdir), device="cpu")
    tt.run(2)
    tt.ckpt.wait()

    # the same keys, in the same order, shapes and dtypes as JAX writes
    jm, tm = _manifest(jdir, 2), _manifest(tdir, 2)
    assert tm["keys"] == jm["keys"]
    assert tm["shapes"] == jm["shapes"] and tm["dtypes"] == jm["dtypes"]
    assert tm["step"] == jm["step"] == 2
    assert tm["extra"] == jm["extra"] == {"model": "llama3.1-8b-reduced"}
    assert {"opt/step", "params/g0/attn/wq", "opt/exp_avg/embed",
            "opt/exp_avg_sq/final_norm/w"} <= set(tm["keys"])

    # JAX -> torch: a fresh torch trainer on the JAX directory resumes there
    tr = Trainer(_torch_config(jdir), device="cpu")
    tr.init_or_restore()
    assert tr.step == 2
    jflat = jax.tree_util.tree_flatten_with_path(jt.state)[0]
    tleaves = [t for t in tree_leaves([tr.state.params, tr.state.opt.step,
                                       tr.state.opt.exp_avg,
                                       tr.state.opt.exp_avg_sq])]
    assert len(jflat) == len(tleaves)
    for (path, a), b in zip(jflat, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                      err_msg=jax.tree_util.keystr(path))

    # torch -> JAX: the JAX manager restores the torch checkpoint
    like = jax.eval_shape(lambda: jax_init_train_state(
        jt.model, jt.rules, ParallelConfig()))
    restored, manifest = JCheckpointManager(tdir).restore(like)
    assert manifest["step"] == 2
    want = [tt.state.params, tt.state.opt.step, tt.state.opt.exp_avg,
            tt.state.opt.exp_avg_sq]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                            tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                      err_msg=jax.tree_util.keystr(path))


def test_checkpoint_roundtrip_bf16_and_retention(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.linspace(-2, 2, 4).bfloat16()},
            "s": torch.tensor(3, dtype=torch.int32)}
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for step in (10, 20, 30):
        cm.save(step, tree)
    assert cm.latest_step() == 30
    assert len([x for x in os.listdir(tmp_path) if x.startswith("step_")]) == 2
    like = {"a": torch.zeros(2, 3), "nested": {"b": torch.zeros(4).bfloat16()},
            "s": torch.zeros((), dtype=torch.int32)}
    out, manifest = cm.restore(like)
    assert out is like and manifest["step"] == 30
    assert manifest["dtypes"]["nested/b"] == "bfloat16"
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the bf16 leaf restores through the JAX manager too
    jout, _ = JCheckpointManager(str(tmp_path)).restore(
        {"a": np.zeros((2, 3), np.float32),
         "nested": {"b": jax.numpy.zeros(4, jax.numpy.bfloat16)},
         "s": np.zeros((), np.int32)})
    np.testing.assert_array_equal(np.asarray(jout["nested"]["b"], np.float32),
                                  tree["nested"]["b"].float().numpy())


def test_checkpoint_crash_mid_write_preserves_previous(tmp_path):
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    cm.save(10, tree)
    cm.wait()
    stale = tmp_path / ".tmp-step_00000020"
    stale.mkdir()
    (stale / "manifest.json").write_text("{ truncated")
    assert cm.latest_step() == 10
    out, man = cm.restore({"x": torch.zeros(4)})
    assert man["step"] == 10 and torch.equal(out["x"], tree["x"])
    cm.save(30, tree)
    cm.wait()
    assert not [x for x in os.listdir(tmp_path) if x.startswith(".tmp-step_")]
    assert cm.latest_step() == 30
    with pytest.raises(ValueError, match="shape"):
        cm.restore({"x": torch.zeros(5)})


def test_hook_matches_repro_core_float_for_float():
    """20 iterations of the co-simulation hook (NodeSim + SimBackend +
    PowerManager on the full llama3.1-8b workload cut to 8 layers): every
    history entry, metric and cap vector equal to repro.core's."""
    kw = dict(sampling_period=2, warmup=1, window_size=1)
    jh = JLitSiliconHook(jax_get_config("llama3.1-8b").replace(n_layers=8),
                         JManagerConfig(use_case="gpu-red", **kw),
                         preset="mi300x", seed=1)
    th = LitSiliconHook(get_config("llama3.1-8b").replace(n_layers=8),
                        ManagerConfig(use_case="gpu-red", **kw),
                        preset="mi300x", seed=1)
    for step in range(20):
        jmet, tmet = {"step": step}, {"step": step}
        jh(step, jmet, None)
        th(step, tmet, None)
        assert jmet == tmet
        np.testing.assert_array_equal(jh.backend.get_power_caps(),
                                      th.backend.get_power_caps())
    assert len(jh.node.history) == len(th.node.history) == 20
    for a, b in zip(jh.node.history, th.node.history):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert [c.tolist() for c in jh.manager.adjust_log] == \
        [c.tolist() for c in th.manager.adjust_log]
    assert len(th.manager.adjust_log) >= 1


def test_trainer_loss_decreases_and_restarts(tmp_path):
    """tests/test_integration.py's first mirror: reduced llama3.1-8b, lr
    3e-3, 30 steps, checkpoints every 15; a new trainer resumes at 30."""
    tc = TrainerConfig(
        model=get_reduced_config("llama3.1-8b"),
        train=TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                          checkpoint_every=15,
                          checkpoint_dir=str(tmp_path / "ck")),
        data=DataConfig(global_batch=8, seq_len=64))
    tr = Trainer(tc, device="cpu")
    log = tr.run(30)
    assert log[-1]["loss"] < log[0]["loss"] - 0.2
    assert [m["step"] for m in log] == list(range(30))
    tr.ckpt.wait()
    tr2 = Trainer(tc, device="cpu")
    tr2.init_or_restore()
    assert tr2.step == 30
    for a, b in zip(tree_leaves(tr2.state), tree_leaves(tr.state)):
        assert torch.equal(a, b)
    log2 = tr2.run(3)
    assert log2[-1]["step"] == 32 and np.isfinite(log2[-1]["loss"])


def test_trainer_with_lit_silicon_hook(tmp_path):
    """tests/test_integration.py's second mirror: the hook reports the node
    and moves the caps at least once, within the TDP."""
    hook = LitSiliconHook(
        get_config("llama3.1-8b").replace(n_layers=8),
        ManagerConfig(use_case="gpu-red", sampling_period=2, warmup=1,
                      window_size=1),
        preset="mi300x", seed=1)
    tc = TrainerConfig(
        model=get_reduced_config("llama3.1-8b"),
        train=TrainConfig(checkpoint_every=0,
                          checkpoint_dir=str(tmp_path / "ck")),
        data=DataConfig(global_batch=4, seq_len=32))
    log = Trainer(tc, hooks=[hook], device="cpu").run(30)
    assert "sim/node_power" in log[-1]
    assert len(hook.manager.adjust_log) >= 1
    assert hook.backend.get_power_caps().max() <= hook.backend.tdp + 1e-6


def test_trainer_rolls_back_on_a_non_finite_loss(tmp_path):
    """The watchdog's rollback restores the last checkpoint in place."""
    tc = _torch_config(str(tmp_path / "ck"), steps=2)
    tr = Trainer(tc, device="cpu")
    tr.run(2)
    tr.ckpt.wait()
    saved = [t.clone() for t in tree_leaves(tr.state.params)]
    with torch.no_grad():
        tr.state.params["embed"].fill_(float("nan"))
    tr.run(1)                                 # NaN loss: back to step 2
    assert tr.step == 2 and tr.watchdog.rollbacks == 1
    for a, b in zip(tree_leaves(tr.state.params), saved):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-v3-16b", "rwkv6-3b"])
def test_trainer_refuses_moe_and_rwkv(arch, tmp_path):
    tc = TrainerConfig(model=get_reduced_config(arch),
                       train=TrainConfig(checkpoint_dir=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(tc, device="cpu")
