"""The port's training path against the JAX package, on the CPU.

Loss, metrics and every gradient leaf of reduced fp32 ``llama3.1-8b`` and
``qwen3-4b`` against ``jax.value_and_grad(model.loss)`` on parameters
carried over by the bridge; the gradients of the two kernel modules on the
path (RMSNorm, flash attention: their plain backward from the log-sum-exp
and autograd of their plain forward) against ``jax.grad`` of the JAX
package's plain forms; GELU, cross-entropy with z-loss, AdamW, the schedule,
the clip and the synthetic data against the JAX functions.

Tolerances, all fp32: 2e-5 on the loss and on values of unit scale (the JAX
package's fp32 kernel tolerance; the two sides differ in summation order
only, ~1e-6), gradients to 2e-5 of each leaf's largest magnitude, AdamW
state to 1e-6 relative (elementwise arithmetic in the same order); GELU to
2e-6 (both tanh forms, ~1e-7 apart); batches of tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import build_model as jax_build
from repro.models.attention import sdpa_flash
from repro.models.common import activation_fn as jax_activation
from repro.models.common import cross_entropy_loss as jax_ce
from repro.models.common import init_params as jax_init
from repro.models.common import rmsnorm as jax_rmsnorm
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticTokens as JSyntheticTokens
from repro.train.optimizer import adamw_update as jax_adamw
from repro.train.optimizer import clip_by_global_norm as jax_clip
from repro.train.optimizer import init_state as jax_init_state
from repro.train.optimizer import lr_schedule as jax_lr
from repro_torch.configs import TrainConfig, get_reduced_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from repro_torch.models import build_model
from repro_torch.models.bridge import train_params_from_numpy
from repro_torch.models.common import (activation_fn, cross_entropy_loss,
                                       tree_leaves)
from repro_torch.train.data import DataConfig, SyntheticTokens
from repro_torch.train.optimizer import (adamw_update, clip_by_global_norm,
                                         init_state, lr_schedule)

ARCHS = ["llama3.1-8b", "qwen3-4b"]
TOL = 2e-5


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _rel_close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


# ------------------------------------------------------------- model loss
def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    labels[0, :3] = -100                      # some ignored positions
    return toks, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jc = jax_reduced(arch).replace(compute_dtype="float32")
    tc = get_reduced_config(arch).replace(compute_dtype="float32")
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


def test_training_params_are_float32_leaves_in_the_jax_layout():
    cfg = get_reduced_config("llama3.1-8b")
    model = build_model(cfg)
    params = model.init_train_params(torch.Generator().manual_seed(0), "cpu")
    assert set(params) == {"embed", "final_norm", "lm_head", "g0"}
    wq = params["g0"]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.q_dim)
    assert wq.is_leaf and wq.requires_grad
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in tree_leaves(params))


def test_bf16_compute_casts_fp32_params_at_use():
    """fp32 master weights, bf16 activations: the model casts each matrix
    where it uses it, and the gradients come back fp32 on every leaf."""
    cfg = get_reduced_config("qwen3-4b")
    model = build_model(cfg)
    params = model.init_train_params(torch.Generator().manual_seed(0), "cpu")
    toks, labels = _batch(cfg)
    loss, _ = model.loss(params, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    loss.backward()
    assert torch.isfinite(loss)
    for t in tree_leaves(params):
        assert t.grad is not None and t.grad.dtype == torch.float32
        assert bool(t.grad.abs().max() > 0)


# ---------------------------------------------------------- common pieces
def test_gelu_is_the_tanh_form_of_jax():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = activation_fn("gelu")(torch.from_numpy(x))
    want = jax_activation("gelu")(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("z", [0.0, 1e-4])
@pytest.mark.parametrize("ignored", ["some", "all"])
def test_cross_entropy_matches_jax(z, ignored):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[:, -2:] = -100
    if ignored == "all":
        labels[:] = -100                      # the denominator clamps at 1
    jl, jm = jax_ce(jnp.asarray(logits), jnp.asarray(labels), z)
    tl, tm = cross_entropy_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), z)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(float(tl), float(jl), atol=TOL, rtol=TOL)
    jg = jax.grad(lambda x: jax_ce(x, jnp.asarray(labels), z)[0])(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    cross_entropy_loss(t, torch.from_numpy(labels), z)[0].backward()
    np.testing.assert_allclose(_np(t.grad), np.asarray(jg), atol=1e-7,
                               rtol=TOL)


# -------------------------------------------------------- kernel backwards
@pytest.mark.parametrize("d", [16, 128, 2560])
def test_rmsnorm_gradients_match_jax(d):
    """The port's RMSNorm op (autograd of the plain version on the CPU) and
    the backward kernel's plain oracle, against jax.grad of the JAX
    package's rmsnorm."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((3, 5, d)).astype(np.float32)
    jx, jw = jax.grad(lambda a, b: jnp.sum(jax_rmsnorm(a, b) * dy),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (rms_ops.rmsnorm(tx, tw) * torch.from_numpy(dy)).sum().backward()
    _rel_close(tx.grad, jx, what="dx")
    _rel_close(tw.grad, jw, what="dw")
    bx, bw = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(dy))
    _rel_close(bx, jx, what="dx, plain backward")
    _rel_close(bw, jw, what="dw, plain backward")


FLASH_CASES = {  # (B, Sq, Sk, H, kvH, D, causal, window, q_offset)
    "causal": (2, 40, 40, 4, 2, 16, True, 0, 0),
    "window": (1, 50, 50, 8, 2, 32, True, 12, 0),
    "offset": (2, 24, 56, 4, 1, 16, True, 9, 32),
    "noncausal": (1, 33, 33, 4, 4, 16, False, 0, 0),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_gradients_match_jax(case):
    """dQ, dK, dV from the plain backward (P from the log-sum-exp) and from
    autograd of the plain forward, against jax.grad of the JAX package's
    sdpa_flash; the log-sum-exp against JAX's logsumexp of the masked
    scores."""
    B, Sq, Sk, H, kvH, D, causal, window, off = FLASH_CASES[case]
    rng = np.random.default_rng(7)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, kvH, D)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=off)

    def f(a, b, c):
        return jnp.sum(sdpa_flash(a, b, c, causal=causal, window_eff=window,
                                  chunk=16, q_offset=off) * do)
    jg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa_ops.flash_attention(tq, tk, tv, **kw)
    (o * torch.from_numpy(do)).sum().backward()
    with torch.no_grad():
        o, lse = flash_attention_ref(tq, tk, tv, chunk=16, return_lse=True,
                                     **kw)
        bwd = flash_attention_bwd_ref(tq, tk, tv, o, lse,
                                      torch.from_numpy(do), chunk=16, **kw)
    for name, t, b, j in zip("qkv", (tq, tk, tv), bwd, jg):
        _rel_close(t.grad, j, what=f"d{name}, autograd")
        _rel_close(b, j, what=f"d{name}, plain backward")

    qi = np.arange(Sq)[:, None] + off
    ki = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= ki <= qi
    if window:
        vis &= ki > qi - window
    G = H // kvH
    s = jnp.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, kvH, G, D), k) \
        * D ** -0.5
    want = jax.nn.logsumexp(jnp.where(vis, s, -1e30), -1).reshape(B, H, Sq)
    _rel_close(lse, want, what="lse")


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset,want", [
    (8, 8, True, 0, 0, True), (8, 8, True, 3, 0, True),
    (8, 4, True, 0, -4, True), (8, 4, True, 0, -5, False),
    (4, 20, True, 0, 16, True), (6, 4, False, 2, 0, False),
    (6, 4, False, 3, 0, True), (5, 0, False, 0, 0, False),
    (0, 5, True, 0, 0, True), (5, 9, False, 0, -3, True)])
def test_every_query_sees_a_key_by_brute_force(Sq, Sk, causal, window,
                                                q_offset, want):
    qi = np.arange(Sq)[:, None] + q_offset
    ki = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= ki <= qi
    if window:
        vis &= ki > qi - window
    brute = bool(vis.any(1).all()) if Sq else True
    if q_offset >= 0 or not causal:
        assert brute == want
    got = fa_ops.every_query_sees_a_key(Sq, Sk, causal=causal, window=window,
                                        q_offset=q_offset)
    # negative offsets with causal attention are refused outright: a
    # superset of the rows that see nothing
    assert got == (brute and not (causal and q_offset < 0))


# --------------------------------------------------------------- optimizer
def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((4, 3))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(5)).astype(np.float32),
                  "d": (scale * rng.standard_normal((2, 2, 2))).astype(
                      np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_steps_match_jax(steps):
    """Parameters and both moments after 1 and 3 steps (warmup, clip on:
    the gradients' norm is above grad_clip), and each step's metrics."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               grad_clip=1.0)
    jcfg, tcfg = JTrainConfig(**cfg), TrainConfig(**cfg)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=2.0) for _ in range(steps)]
    jp, js = p0, jax_init_state(jax.tree_util.tree_map(jnp.asarray, p0))
    tp = _to_torch(p0)
    ts = init_state(tp)
    for g in grads:
        jp, js, jm = jax_adamw(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                               jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts, tm = adamw_update(tcfg, tp, _to_torch(g), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == steps
    for got, want in ((tp, jp), (ts.exp_avg, js.exp_avg),
                      (ts.exp_avg_sq, js.exp_avg_sq)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


def test_lr_schedule_matches_jax():
    for cfg in (dict(lr=3e-3, warmup_steps=5, total_steps=60),
                dict(lr=1e-3, warmup_steps=1, total_steps=10,
                     min_lr_frac=0.2)):
        jcfg, tcfg = JTrainConfig(**cfg), TrainConfig(**cfg)
        for step in range(0, cfg["total_steps"] + 5):
            got = lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
            want = jax_lr(jcfg, jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(5))
    jg, jn = jax_clip(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tg, tn = clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_tokens_identical_to_jax(hosts):
    jm, tm = jax_reduced("llama3.1-8b"), get_reduced_config("llama3.1-8b")
    for host in range(hosts):
        kw = dict(global_batch=4, seq_len=48, seed=9, n_hosts=hosts,
                  host_index=host)
        jd = JSyntheticTokens(JDataConfig(**kw), jm)
        td = SyntheticTokens(DataConfig(**kw), tm)
        for step in (0, 1, 17):
            a, b = jd.batch_at(step), td.batch_at(step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
