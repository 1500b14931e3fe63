"""The port's explicit collectives (``parallel/collectives.py``) and int8
gradient compression (``parallel/compression.py``), on the CPU.

* A gloo world of 4 processes, spawned once (``torch.multiprocessing``):
  mirrors of ``tests/test_multidevice.py:30,101,49`` against the plain
  references those tests use: ``ring_all_gather`` returns every shard in
  rank order (exact), the prefetching FFN chain equals the plain chain
  (atol 1e-4), and ``compressed_psum`` is within half a quantum a rank of
  the exact sum.
* The compression functions against the JAX functions on the same numpy
  inputs, mirroring ``tests/test_train_substrate.py:143-170``: the same
  int8 payload and scale, the error bound of half a quantum, the error
  feedback's running mean, the tree round trip.
* The port's ``Trainer`` with ``grad_compression="int8"`` against the JAX
  ``Trainer`` with it on reduced fp32 llama3.1-8b over 3 steps from the
  same parameters (``models/bridge.py``): each loss within 2e-5 relative
  (the most read 1.4e-7); and each step taken from JAX's state before it
  (parameters, moments, error): the dequantized gradients and the new
  error within 2e-5 of the leaf's largest |g + e| (fp32), except elements
  that a rounding flip moves by exactly one quantum (their slice's
  scale): the raw gradients differ by fp32 rounding between the two, and
  a value within that of a rounding boundary (x.5 quanta) lands on the
  other side.  At most 1% of a leaf's elements may flip (``FLIP_SHARE``;
  the most read was 2 of 8,192).  Run free, a flip carries on (the error
  feedback adds it to the next payload, and AdamW moves the element by a
  whole step where its update went from zero to one quantum), so the
  elementwise comparison is made from a shared state.
* Checkpoints with the error tree: the keys JAX writes (``err/...``), and
  each package's restores through the other's bit for bit.
"""
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
from repro.configs import get_reduced_config as jax_reduced
from repro.parallel.act import activation_sharding as jax_activation_sharding
from repro.parallel import compression as jc
from repro.parallel.fsdp import init_train_state as jax_init_train_state
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.data import DataConfig as JDataConfig
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import ParallelConfig, TrainConfig
from repro_torch.configs import get_reduced_config
from repro_torch.models.bridge import train_params_from_numpy
from repro_torch.parallel import compression as tc
from repro_torch.parallel.collectives import (make_fsdp_prefetch_fn,
                                              ring_all_gather)
from repro_torch.parallel.fsdp import TrainState
from repro_torch.train.checkpoint import flatten_with_paths
from repro_torch.train.data import DataConfig
from repro_torch.train.optimizer import init_state
from repro_torch.train.train_loop import Trainer, TrainerConfig

TOL = 2e-5                      # fp32 (tests/test_kernels.py)
FLIP_SHARE = 0.01               # elements a rounding flip may move, a leaf
SPAWN_TIMEOUT = 120.0
WORLD = 4
INT8 = "int8"


# --------------------------------------------------------------------------- #
# The gloo world
# --------------------------------------------------------------------------- #
def _worker(rank, world, port, out):
    """One rank: the three collectives of tests/test_multidevice.py on the
    world's group; rank 0 saves what they returned."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", rank=rank, world_size=world)
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    ring = ring_all_gather(x.chunk(world)[rank])
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(3, 32, 32)).astype(np.float32)
                          * 0.1)
    chain = make_fsdp_prefetch_fn()(xs, ws)
    rows = torch.from_numpy(np.random.default_rng(1).normal(
        size=(world, 64)).astype(np.float32))
    psum = tc.compressed_psum(rows[rank])
    torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save({"x": x, "ring": ring, "xs": xs, "ws": ws,
                    "chain": chain, "rows": rows, "psum": psum}, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives") / "w.pt"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_worker, args=(WORLD, port, str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"world {WORLD} did not finish in {SPAWN_TIMEOUT} s")
    return torch.load(out)


def test_ring_all_gather_matches_allgather(world):
    """Every rank's shard of x, stacked in rank order: x itself."""
    got = world["ring"]
    assert got.shape == (WORLD, 8 // WORLD, 4)
    np.testing.assert_allclose(got.reshape(8, 4).numpy(), world["x"].numpy())


def test_fsdp_prefetch_chain(world):
    """The chain with each layer's gather issued before the previous
    layer's matmul equals the plain chain on the whole weights."""
    ref = world["xs"]
    for i in range(world["ws"].shape[0]):
        ref = torch.relu(ref @ world["ws"][i])
    np.testing.assert_allclose(world["chain"].numpy(), ref.numpy(),
                               atol=1e-4)


def test_compressed_psum_close_to_exact(world):
    rows = world["rows"]
    exact = rows.sum(0)
    scale = float(rows.abs().max()) / 127.0
    err = float((world["psum"] - exact).abs().max())
    assert err <= WORLD * scale * 0.5 + 1e-6


# --------------------------------------------------------------------------- #
# The compression functions against JAX's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(6))
def test_quantize_matches_jax_and_its_error_bound(seed):
    """The same payload and scales as JAX's quantize_int8 on the same
    input (slices along the last axis), and the error bound of
    tests/test_train_substrate.py:143."""
    rng = np.random.default_rng(seed)
    shape = [(64,), (5, 17), (3, 4, 33)][seed % 3]
    x = (rng.normal(size=shape) * rng.uniform(0.01, 100)).astype(np.float32)
    if seed == 5:
        x[..., 0] = 0.0
        x[0] = 0.0                                   # an all-zero slice
    q, s = tc.quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jax.numpy.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    err = np.abs(tc.dequantize_int8(q, s).numpy() - x)
    assert (err <= s.numpy() * 0.5 + 1e-6).all()


def test_error_feedback_compensates_as_jax():
    """tests/test_train_substrate.py:158 on the port: with feedback the
    mean of 50 dequantized payloads tracks g; each step's payload and error
    equal JAX's."""
    g = np.random.default_rng(0).normal(0, 1, (100,)).astype(np.float32)
    err, jerr = torch.zeros(100), jax.numpy.zeros(100)
    total = np.zeros(100)
    for _ in range(50):
        q, s, err = tc.compress_with_feedback(torch.from_numpy(g), err)
        jq, js, jerr = jc.compress_with_feedback(jax.numpy.asarray(g), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr),
                                   rtol=0, atol=TOL * float(np.abs(g).max()))
        total += tc.dequantize_int8(q, s).numpy()
    np.testing.assert_allclose(total / 50, g, atol=np.abs(g).max() / 120)


def test_compressed_grad_tree_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(6, 10)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32) * 1e-3}}
    errs = {"a": rng.normal(size=(6, 10)).astype(np.float32) * 0.01,
            "b": {"c": np.zeros(7, np.float32)}}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict)  # noqa: E731
                      else torch.from_numpy(v) for k, v in t.items()}
    got_g, got_e = tc.compressed_grad_tree(to_t(tree), to_t(errs))
    want_g, want_e = jc.compressed_grad_tree(tree, errs)
    for got, want in ((got_g, want_g), (got_e, want_e)):
        for (k, a), b in zip(flatten_with_paths(got),
                             jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7, err_msg=k)
    zeros = tc.init_error_tree(to_t(tree))
    assert all(z.dtype == torch.float32 and not z.any()
               for _, z in flatten_with_paths(zeros))
    # the tree function returns new trees: its inputs are left as they were
    np.testing.assert_array_equal(to_t(tree)["a"].numpy(), tree["a"])


# --------------------------------------------------------------------------- #
# The int8 Trainer against JAX's
# --------------------------------------------------------------------------- #
def _train_cfg(ckdir, every=0):
    return dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=1e9,
                checkpoint_every=every, checkpoint_dir=str(ckdir))


def _jax_trainer(ckdir, every=0):
    return JTrainer(JTrainerConfig(
        model=jax_reduced("llama3.1-8b").replace(compute_dtype="float32"),
        train=JTrainConfig(**_train_cfg(ckdir, every)),
        parallel=JParallelConfig(grad_compression=INT8),
        data=JDataConfig(global_batch=8, seq_len=16)))


def _torch_trainer(ckdir, every=0):
    return Trainer(TrainerConfig(
        model=get_reduced_config("llama3.1-8b").replace(
            compute_dtype="float32"),
        train=TrainConfig(**_train_cfg(ckdir, every)),
        parallel=ParallelConfig(grad_compression=INT8),
        data=DataConfig(global_batch=8, seq_len=16)), device="cpu")


def _by_key(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def quantum_close(got, want, scale, largest, what):
    """``got`` within TOL * largest of ``want`` everywhere but where the two
    are exactly one quantum (``scale``, per slice) apart, which at most
    FLIP_SHARE of the elements may be; returns the share that flipped."""
    d = np.abs(got.astype(np.float64) - want)
    tol = TOL * largest
    flip = (d > tol) & (np.abs(d - np.broadcast_to(scale, d.shape)) <= tol)
    bad = (d > tol) & ~flip
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements off by up to "
                           f"{d[bad].max():.3e} (tol {tol:.3e})")
    share = float(flip.mean()) if d.size else 0.0
    assert share <= FLIP_SHARE, f"{what}: {share:.2%} flipped"
    return share


def _from_jax(state, model) -> TrainState:
    """The port's copy of a JAX int8 TrainState (host numpy in between)."""
    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(np.array(t)))
    params = train_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, state.params), model, "cpu")
    opt = init_state(params)._replace(
        step=tree(state.opt.step), exp_avg=tree(state.opt.exp_avg),
        exp_avg_sq=tree(state.opt.exp_avg_sq))
    return TrainState(params, opt, tree(state.err))


def test_int8_trainer_matches_jax_trainer(tmp_path):
    jt = _jax_trainer(tmp_path / "jax")
    jt.init_or_restore()
    free = _torch_trainer(tmp_path / "free")         # its own 3 steps
    free.state = _from_jax(jt.state, free.model)
    shared = _torch_trainer(tmp_path / "shared")     # each from JAX's state

    @jax.jit
    def raw_grads(params, batch):
        def loss(p):
            with jax_activation_sharding(jt.mesh, jt.rules.activation_rules()):
                return jt.model.loss(p, batch)
        return jax.grad(lambda p: loss(p)[0])(params)

    flips = []
    for step in range(3):
        shared.state, shared.step = _from_jax(jt.state, shared.model), step
        batch = {k: jax.numpy.asarray(v)
                 for k, v in jt.data.batch_at(step).items()}
        with jt.mesh:
            g = raw_grads(jt.state.params, batch)
        want_g, want_e = jc.compressed_grad_tree(g, jt.state.err)
        scale = jax.tree_util.tree_map(
            lambda a, e: jc.compress_with_feedback(a, e)[1], g, jt.state.err)
        largest = jax.tree_util.tree_map(
            lambda a, e: float(np.abs(np.asarray(a + e)).max()),
            g, jt.state.err)
        want = jt.run(1)[-1]
        for tr in (free, shared):
            got = tr.run(1)[-1]
            assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"]), \
                f"step {step} loss: port {got['loss']} vs JAX {want['loss']}"
        keys = zip(_by_key(want_g).items(), _by_key(want_e).values(),
                   _by_key(jt.state.err).values(), _by_key(scale).values(),
                   _by_key(largest).values())
        port_g = dict(flatten_with_paths(shared.state.params))
        port_e = dict(flatten_with_paths(shared.state.err))
        assert len(port_g) == len(_by_key(want_g))
        for (jkey, wg), we, step_e, s, big in keys:
            key = jkey.replace("']['", "/").strip("[']")
            # JAX's jitted step took the round trip recomputed here
            quantum_close(step_e, we, s, big, f"step {step} JAX err {key}")
            flips.append(quantum_close(port_g[key].grad.numpy(), wg, s, big,
                                       f"step {step} grad {key}"))
            flips.append(quantum_close(port_e[key].numpy(), step_e, s, big,
                                       f"step {step} err {key}"))
    assert all(np.isfinite(e.numpy()).all()
               for _, e in flatten_with_paths(free.state.err))
    assert max(flips) <= FLIP_SHARE


def test_int8_checkpoints_cross_restore_with_err(tmp_path):
    """JAX's int8 TrainState (``err/...`` keys) restores in the port's int8
    trainer bit for bit, and the port's int8 checkpoint through JAX's
    CheckpointManager."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jt = _jax_trainer(jdir, every=2)
    jt.run(2)
    jt.ckpt.wait()
    tt = _torch_trainer(tdir, every=2)
    tt.run(2)
    tt.ckpt.wait()
    import json
    manifests = [json.loads((d / "step_00000002" / "manifest.json")
                            .read_text()) for d in (jdir, tdir)]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert "err/g0/attn/wq" in manifests[1]["keys"]
    # JAX -> torch
    tr = _torch_trainer(jdir)
    tr.init_or_restore()
    assert tr.step == 2
    want = _by_key(jt.state)
    got = flatten_with_paths(tr.state)
    assert len(got) == len(want)
    for (key, t), (jkey, a) in zip(got, want.items()):
        np.testing.assert_array_equal(t.detach().numpy(), a, err_msg=key)
    # torch -> JAX
    like = jax.eval_shape(lambda: jax_init_train_state(
        jt.model, jt.rules, JParallelConfig(grad_compression=INT8)))
    restored, manifest = JCheckpointManager(str(tdir)).restore(like)
    assert manifest["step"] == 2 and restored.err is not None
    for (key, t), a in zip(flatten_with_paths(tt.state),
                           jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), t.detach().numpy(),
                                      err_msg=key)
