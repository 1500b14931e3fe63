"""The port's MoE training against the JAX package, on the CPU.

* The grouped GEMM's plain backward (``moe_gemm_bwd_ref``: the oracle of
  the ``dgrad`` and ``wgrad`` kernels) against autograd of the plain
  forward and ``jax.vjp`` of the JAX ``moe_gemm_ref``; the op's CPU
  backward is that plain backward.
* The dispatch's backward (a gather through the inverse map, summed over
  k) against autograd of the plain gather.
* The MoE block's output, aux loss and gradients (input, router, experts,
  shared experts) against ``jax.vjp`` of ``repro.models.moe.moe_forward``,
  for both routers, with a capacity that drops tokens.
* Loss and every gradient of reduced fp32 ``deepseek-v3-16b`` and
  ``deepseek-moe-16b`` against ``jax.value_and_grad(model.loss)``, tokens
  dropped.
* The global dispatch of sharded training (``MoEGroup``) in one process:
  the ranks' parts of a batch, each routed with the counts of the others,
  give the single-device block's output, kept set, aux and gradients.
* ``Trainer`` on reduced ``deepseek-v3-16b``, mirroring
  ``tests/test_integration.py``: the loss falls by 0.2 in 30 steps, a
  restart resumes, the gpu-red hook moves the caps; checkpoints
  cross-restore with the JAX ``CheckpointManager``, stacked expert leaves
  included; the entry point trains the MoE family and keeps its dense
  first layer under ``--layers``.

Tolerances, all fp32 unless said: 2e-5 on losses and on gradients of each
leaf's largest magnitude (the two sides sum in another order, ~1e-6; the
combine adds a token's k outputs in top-k order, JAX's scatter in expert
order), 1e-5 on the block's output (``tests/test_torch_moe.py``), 1e-6 on
the aux loss; the plain backward 2e-5 fp32 and 2e-2 bf16, times sqrt of
the contraction's length as atol (``tests/test_kernels.py``'s GEMM rule).
Every routing call asserts its k-th and (k+1)-th scores are more than
1e-5 apart, so that top-k picks the same experts on both sides.
"""
import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.kernels.moe_gemm import moe_gemm_ref as jax_moe_gemm_ref
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.models.common import init_params as jax_init
from repro.parallel.fsdp import init_train_state as jax_init_train_state
from repro.parallel.sharding import ShardingRules as JShardingRules
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import TrainConfig, get_config, get_reduced_config
from repro_torch.core.manager import ManagerConfig
from repro_torch.kernels import _build
from repro_torch.kernels.moe_gemm import kernel as moe_kernel
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref, moe_gemm_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import train_params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.train.data import DataConfig
from repro_torch.train.train_loop import LitSiliconHook, Trainer, TrainerConfig

ARCHS = ["deepseek-v3-16b", "deepseek-moe-16b"]
TOL = 2e-5
BLOCK_TOL = 1e-5
GAP = 1e-5
DROPS = dict(capacity_factor=0.5)      # as tests/test_integration.py's MoE
GEMM_TOL = {"float32": (jnp.float32, torch.float32, 2e-5),
            "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _cfgs(arch, **moe_kw):
    jc = jax_reduced(arch).replace(compute_dtype="float32")
    tc = get_reduced_config(arch).replace(compute_dtype="float32")
    if moe_kw:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _rel_close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


def _torch_tree(tree, grad=False):
    return {k: (_torch_tree(v, grad) if isinstance(v, dict) else
                torch.from_numpy(np.array(v, np.float32)).requires_grad_(grad))
            for k, v in tree.items()}


@pytest.fixture
def routes(monkeypatch):
    """Every routing call of the port: its expert indices, after asserting
    that no token's k-th and (k+1)-th scores are within GAP."""
    seen = []
    route = tmoe._route

    def recording(cfg, logits):
        with torch.no_grad():
            scores, _ = tmoe._scores(cfg, logits)
            top = torch.topk(scores, cfg.moe.top_k + 1, dim=-1).values
        assert float((top[:, -2] - top[:, -1]).min()) > GAP
        out = route(cfg, logits)
        seen.append(out[1])
        return out

    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


def _dropped(cfg, idx, n_tokens):
    """Some expert was routed more assignments than the capacity holds."""
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
    return int(counts.max()) > tmoe.capacity(cfg, n_tokens)


# ------------------------------------------------------ the plain backward
@pytest.mark.parametrize("ECdh", [(4, 64, 96, 200), (2, 100, 48, 64),
                                  (8, 8, 16, 16), (3, 37, 100, 45)])
@pytest.mark.parametrize("dtype", list(GEMM_TOL))
def test_moe_gemm_bwd_ref_matches_autograd_and_jax_vjp(dtype, ECdh):
    E, C, d, h = ECdh
    jdt, tdt, tol = GEMM_TOL[dtype]
    rng = np.random.default_rng(7)
    x, w, dy = (rng.standard_normal(s).astype(np.float32)
                for s in ((E, C, d), (E, d, h), (E, C, h)))
    tx, tw, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    dx, dw = moe_gemm_bwd_ref(tx, tw, tdy)
    assert (dx.dtype, dw.dtype) == (tdt, tdt)
    assert dx.shape == (E, C, d) and dw.shape == (E, d, h)
    ax, aw = (t.clone().requires_grad_() for t in (tx, tw))
    moe_gemm_ref(ax, aw).backward(tdy)
    _, vjp = jax.vjp(jax_moe_gemm_ref, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp(jnp.asarray(dy, jdt))
    for got, auto, ref, depth in ((dx, ax.grad, jdx, h), (dw, aw.grad, jdw, C)):
        for want in (auto, ref):
            np.testing.assert_allclose(_np(got), _np(want),
                                       atol=tol * np.sqrt(depth), rtol=tol)


def test_moe_gemm_op_on_cpu_runs_the_plain_backward():
    """With a gradient needed, the op's CPU backward is moe_gemm_bwd_ref's,
    and its forward moe_gemm_ref's; without one, the plain forward."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 20, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 24, 40)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 20, 40)).astype(np.float32))
    lx, lw = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = moe_ops.moe_gemm(lx, lw)
    assert y.grad_fn is not None and "MoEGemm" in type(y.grad_fn).__name__
    y.backward(dy)
    dx, dw = moe_gemm_bwd_ref(x, w, dy)
    assert torch.equal(y.detach(), moe_gemm_ref(x, w))
    assert torch.equal(lx.grad, dx) and torch.equal(lw.grad, dw)
    lw.grad = None
    moe_ops.moe_gemm(x, lw).backward(dy)          # x needs no gradient
    assert torch.equal(lw.grad, dw)
    assert moe_ops.moe_gemm(x, w).grad_fn is None


# ------------------------------------------------- the kernels' wrappers
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int}


@pytest.mark.parametrize("entry", ["moe_gemm_dgrad", "moe_gemm_wgrad"])
def test_backward_entry_points_bind_every_parameter(entry):
    """One ctypes type per C parameter, c_void_p for every pointer and the
    stream (an int would cut them to 32 bits), the chosen path last."""
    src = (_build.CSRC / "moe_gemm_bwd.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    assert [_C_TYPES[" ".join(p.split()[:-1])] for p in params.split(",")] \
        == moe_kernel._ARGTYPES
    assert params.split(",")[-1].split() == ["int", "path"]


BF = torch.bfloat16
BWD_PATHS = {   # (a, b, d, h) -> the kernel both forms take
    "bf16 aligned": ((torch.zeros(2, 8, 72, dtype=BF),
                      torch.zeros(2, 8, 136, dtype=BF), 72, 136), "wgmma"),
    "bf16 d not a multiple of 8": ((torch.zeros(2, 8, 100, dtype=BF),
                                    torch.zeros(2, 8, 64, dtype=BF), 100, 64),
                                   "simt"),
    "bf16 h not a multiple of 8": ((torch.zeros(2, 8, 64, dtype=BF),
                                    torch.zeros(2, 8, 45, dtype=BF), 64, 45),
                                   "simt"),
    "bf16 unaligned": ((torch.zeros(2 * 8 * 64 + 4, dtype=BF)[4:].view(
        2, 8, 64), torch.zeros(2, 8, 64, dtype=BF), 64, 64), "simt"),
    "fp32": ((torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), 64, 64), "simt"),
}


@pytest.mark.parametrize("case", list(BWD_PATHS))
def test_moe_gemm_bwd_path_by_dtype_shape_and_alignment(case):
    """bf16 that TMA can read (d and h multiples of 8, 16-byte aligned
    bases) takes the wgmma kernels, the rest the CUDA-core kernel."""
    args, want = BWD_PATHS[case]
    assert moe_kernel.moe_gemm_bwd_path(*args) == want
    assert want in _build.PATHS


@pytest.mark.parametrize("fn", [moe_kernel.moe_gemm_dgrad,
                                moe_kernel.moe_gemm_wgrad])
def test_backward_wrappers_reject_cpu_tensors_before_counting(fn):
    assert set(fn.launches_by_path) == {"wgmma", "simt"}
    n = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros(2, 8, 16), torch.zeros(2, 8, 16))
    with pytest.raises(ValueError, match="expected"):
        fn(torch.zeros(2, 8, 16), torch.zeros(3, 8, 16))
    assert fn.launches == n


# ------------------------------------------------------------- the dispatch
def test_dispatch_and_combine_backwards_gather_what_autograd_scatters():
    """_Gather's backward equals autograd's backward of the plain gather,
    trash and empty slots included: for the dispatch, each token's k slots
    gathered through dest_tok and summed in order; for the combine, each
    slot's one assignment gathered through its inverse."""
    _, tc = _cfgs("deepseek-v3-16b", **DROPS)
    rng = np.random.default_rng(4)
    T, d, k, E = 40, tc.d_model, tc.moe.top_k, tc.moe.n_experts
    xs = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32))
    _, idx, _ = tmoe._route(tc, logits)
    C = tmoe.capacity(tc, T)
    assert _dropped(tc, idx, T)
    flat_e = idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    starts = torch.cumsum(torch.bincount(flat_e, minlength=E), 0) - \
        torch.bincount(flat_e, minlength=E)
    pos = torch.arange(T * k) - starts[se]
    dest = torch.where(pos < C, se * C + pos, E * C)
    dest_tok = torch.empty_like(dest)
    dest_tok[order] = dest
    src = torch.full((E * C + 1,), T, dtype=torch.int64)
    src[dest] = (torch.arange(T * k) // k)[order]
    slot_of = torch.full((E * C + 1,), T * k, dtype=torch.int64)
    slot_of[dest] = order
    y = torch.from_numpy(rng.standard_normal((E * C, d)).astype(np.float32))
    for rows, index, inverse, n, g_rows in (
            (xs, src[:E * C], dest_tok, k, E * C),           # dispatch
            (y, dest_tok, slot_of[:E * C], 1, T * k)):       # combine
        g = torch.from_numpy(
            rng.standard_normal((g_rows, d)).astype(np.float32))
        a, b = rows.clone().requires_grad_(), rows.clone().requires_grad_()
        out = tmoe._Gather.apply(a, index, inverse, n)
        out.backward(g)
        ref = torch.cat([b, b.new_zeros(1, d)])[index]
        ref.backward(g)
        assert torch.equal(out.detach(), ref.detach())
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- the block
def _block_inputs(jc, seed):
    p = jax.tree_util.tree_map(np.asarray, jax_init(
        jmoe.moe_specs(jc), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    return p, x, dout


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_and_gradients_match_jax_vjp_with_drops(arch, routes):
    jc, tc = _cfgs(arch, **DROPS)
    p, x, dout = _block_inputs(jc, seed=3)
    daux = 0.7
    (ref, ref_aux), vjp = jax.vjp(lambda pp, xx: jmoe.moe_forward(jc, pp, xx),
                                  jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dout), jnp.asarray(daux, jnp.float32)))

    tp, tx = _torch_tree(p, grad=True), torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_forward(tc, tp, tx)
    (out * torch.from_numpy(dout)).sum().add(aux * daux).backward()
    assert len(routes) == 1 and _dropped(tc, routes[0], 48)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6
    _rel_close(tx.grad, jgx, what="x")
    flat = jax.tree_util.tree_flatten_with_path(jgp)[0]
    leaves = list(tree_leaves(tp))
    assert len(flat) == len(leaves) == 7
    for (path, g), t in zip(flat, leaves):
        _rel_close(t.grad, g, what=jax.tree_util.keystr(path))


def test_routed_expert_weights_are_cast_to_the_compute_dtype(routes):
    """fp32 master weights with bf16 activations: the block casts the
    routed experts' weights, as JAX does, so the grouped GEMM sees one
    dtype (its kernel takes no mix) and the gradients come back fp32."""
    jc, tc = _cfgs("deepseek-v3-16b")
    p, x, _ = _block_inputs(jc, seed=5)
    tp = _torch_tree(p, grad=True)
    seen = []
    gemm = moe_ops.moe_gemm

    def recording(a, w):
        seen.append((a.dtype, w.dtype))
        return gemm(a, w)

    xb = torch.from_numpy(x).bfloat16()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_ops, "moe_gemm", recording)
        out, aux = tmoe.moe_forward(tc, tp, xb)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 3
    (out.float().sum() + aux).backward()
    for name in ("wg", "wu", "wd"):
        assert tp[name].grad.dtype == torch.float32
        assert float(tp[name].grad.abs().max()) > 0
    ref, _ = jmoe.moe_forward(jc, jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)


# ------------------------------------------------------------ the model
def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return toks, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_loss_and_every_gradient_match_jax_with_drops(arch, routes):
    jc, tc = _cfgs(arch, **DROPS)
    jm, tm = jax_build(jc), build_model(tc)
    jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0))
    toks, labels = _batch(jc)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tp = train_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tm,
                                 "cpu")
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    tl.backward()
    n_moe = tc.n_layers - tc.moe.first_k_dense
    assert len(routes) == 2 * n_moe                 # forward and recompute
    assert any(_dropped(tc, idx, toks.size) for idx in routes)
    assert abs(float(tl.detach()) - float(jl)) <= TOL * max(1.0, abs(float(jl)))
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            TOL * max(1.0, abs(float(jmet[k]))), k
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    leaves = list(tree_leaves(tp))
    assert len(flat) == len(leaves)
    for (path, g), t in zip(flat, leaves):
        assert t.grad is not None, jax.tree_util.keystr(path)
        _rel_close(t.grad, g, what=jax.tree_util.keystr(path))


# --------------------------------------------- the global dispatch, one process
class _Ranks:
    """A stand-in for a split MoEGroup: rank ``rank`` of ``world``, whose
    all-gather returns every rank's counts, computed beforehand."""

    def __init__(self, world, rank, every):
        self.world, self.rank, self.split, self.every = world, rank, True, every

    def all_gather(self, t):
        assert torch.equal(t, self.every[self.rank])
        return self.every


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_batch_routes_as_one_device(arch, world, routes):
    """The ranks' row blocks of one batch, each through moe_forward with the
    others' expert counts: their outputs stacked are the single-device
    block's (the same kept set: a dropped assignment contributes nothing,
    so a different one would show), their aux parts sum to its aux, and the
    gradients summed over ranks are its gradients."""
    _, tc = _cfgs(arch, **DROPS)
    jc, _ = _cfgs(arch, **DROPS)
    p, x, dout = _block_inputs(jc, seed=11)
    B = x.shape[0] * 2
    x, dout = np.concatenate([x, x[::-1] * 0.5]), np.concatenate([dout, dout])
    x = x.reshape(B, -1, tc.d_model)
    S = x.shape[1]

    tp, tx = _torch_tree(p, grad=True), torch.from_numpy(x).requires_grad_()
    want, want_aux = tmoe.moe_forward(tc, tp, tx)
    (want * torch.from_numpy(dout)).sum().add(want_aux).backward()
    want_grads = [t.grad for t in tree_leaves(tp)] + [tx.grad]
    idx = routes[0]
    assert _dropped(tc, idx, B * S)

    rows = B // world
    every = torch.stack([torch.bincount(
        idx[r * rows * S:(r + 1) * rows * S].reshape(-1),
        minlength=tc.moe.n_experts) for r in range(world)])
    tp, tx = _torch_tree(p, grad=True), torch.from_numpy(x).requires_grad_()
    outs, aux = [], 0.0
    for r in range(world):
        sl = slice(r * rows, (r + 1) * rows)
        out, a = tmoe.moe_forward(tc, tp, tx[sl], _Ranks(world, r, every))
        (out * torch.from_numpy(dout[sl])).sum().add(a).backward()
        outs.append(out.detach())
        aux += float(a)
    np.testing.assert_allclose(_np(torch.cat(outs)), _np(want),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
    assert abs(aux - float(want_aux)) <= 1e-6
    for got, ref in zip([t.grad for t in tree_leaves(tp)] + [tx.grad],
                        want_grads):
        _rel_close(got, ref)


def test_replicated_batch_carries_a_share_of_the_aux():
    """Rows the world does not divide: every rank routes the whole batch as
    one device would and carries 1/world of the aux."""
    jc, tc = _cfgs("deepseek-v3-16b", **DROPS)
    p, x, _ = _block_inputs(jc, seed=12)
    tp = _torch_tree(p)
    want, want_aux = tmoe.moe_forward(tc, tp, torch.from_numpy(x))
    group = tmoe.MoEGroup(None, world=3, rank=1, split=False)
    out, aux = tmoe.moe_forward(tc, tp, torch.from_numpy(x), group)
    assert torch.equal(out, want)
    assert abs(3 * float(aux) - float(want_aux)) <= 1e-7


# --------------------------------------------------------------- training
@pytest.fixture
def one_thread():
    """One intra-op thread for the trainer runs, restored after: the test
    runner's workers share the host's cores, and a worker whose torch
    spins a thread per core slows ~30x under the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer_config(ckdir, **kw):
    return TrainerConfig(
        model=get_reduced_config("deepseek-v3-16b"),
        train=TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                          checkpoint_every=15, checkpoint_dir=str(ckdir)),
        data=DataConfig(**(kw or dict(global_batch=8, seq_len=64))))


def test_moe_trainer_loss_decreases_and_restarts(tmp_path, one_thread):
    """tests/test_integration.py's first trainer test on reduced
    deepseek-v3-16b (bf16 compute): the loss falls by at least 0.2 in 30
    steps, a new trainer resumes at step 30 with the same state."""
    tc = _trainer_config(tmp_path / "ck")
    tr = Trainer(tc, device="cpu")
    log = tr.run(30)
    assert log[-1]["loss"] < log[0]["loss"] - 0.2
    assert [m["step"] for m in log] == list(range(30))
    assert all(m["aux_loss"] > 0 for m in log)
    tr.ckpt.wait()
    tr2 = Trainer(tc, device="cpu")
    tr2.init_or_restore()
    assert tr2.step == 30
    for a, b in zip(tree_leaves(tr2.state), tree_leaves(tr.state)):
        assert torch.equal(a, b)
    log2 = tr2.run(3)
    assert log2[-1]["step"] == 32 and np.isfinite(log2[-1]["loss"])


def test_moe_trainer_with_lit_silicon_hook(tmp_path, one_thread):
    """tests/test_integration.py's second trainer test: the hook simulates
    the MoE iteration (deepseek-v3-16b cut to 8 layers) and moves the caps
    at least once, within the TDP."""
    hook = LitSiliconHook(
        get_config("deepseek-v3-16b").replace(n_layers=8),
        ManagerConfig(use_case="gpu-red", sampling_period=2, warmup=1,
                      window_size=1),
        preset="mi300x", seed=1)
    tc = _trainer_config(tmp_path / "ck", global_batch=4, seq_len=32)
    tc.train = TrainConfig(checkpoint_every=0,
                           checkpoint_dir=str(tmp_path / "ck"))
    log = Trainer(tc, hooks=[hook], device="cpu").run(30)
    assert "sim/node_power" in log[-1]
    assert len(hook.manager.adjust_log) >= 1
    assert hook.backend.get_power_caps().max() <= hook.backend.tdp + 1e-6


def test_moe_checkpoints_cross_restore_with_jax(tmp_path, one_thread):
    """JAX's initial state of reduced deepseek-v3-16b, saved by the JAX
    CheckpointManager, restores into the torch Trainer leaf for leaf; the
    torch Trainer's checkpoint after 2 steps restores through the JAX
    manager, stacked (layers, experts, d, h) leaves included."""
    jc = jax_reduced("deepseek-v3-16b")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jm = jax_build(jc)
    rules = JShardingRules(mesh, jc, JParallelConfig())
    jstate = jax_init_train_state(jm, rules, JParallelConfig(), seed=3)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    JCheckpointManager(str(jdir), async_write=False).save(0, jstate)

    tc = _trainer_config(jdir)
    tr = Trainer(tc, device="cpu")
    tr.init_or_restore()
    assert tr.step == 0
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tleaves = list(tree_leaves(tr.state))
    assert len(jflat) == len(tleaves)
    keys = [jax.tree_util.keystr(p) for p, _ in jflat]
    assert any("'g1'" in k and "'wg'" in k for k in keys)
    for (path, a), b in zip(jflat, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                      err_msg=jax.tree_util.keystr(path))

    tt = Trainer(_trainer_config(tdir), device="cpu")
    tt.run(2)
    tt.save()
    tt.ckpt.wait()
    like = jax.eval_shape(lambda: jax_init_train_state(
        jm, rules, JParallelConfig()))
    restored, manifest = JCheckpointManager(str(tdir)).restore(like)
    assert manifest["step"] == 2
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                            tree_leaves(tt.state)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                      err_msg=jax.tree_util.keystr(path))
    assert tt.state.params["g1"]["ffn"]["wg"].shape == (3, 4, 64, 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_entry_point_trains_moe_and_keeps_the_dense_layer(
        arch, tmp_path, capsys, one_thread):
    assert launch_train.main([
        "--arch", arch, "--reduced", "--layers", "2", "--steps", "3",
        "--device", "cpu", "--global-batch", "2", "--seq-len", "16",
        "--checkpoint-every", "0", "--checkpoint-dir", str(tmp_path)]) == 0
    assert f"arch={arch}-reduced device=cpu step 2" in capsys.readouterr().out
    model = build_model(get_reduced_config(arch).replace(n_layers=2))
    assert model.layer_groups() == [(1, True), (1, False)]
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", arch, "--reduced", "--layers", "1",
                           "--device", "cpu"])
