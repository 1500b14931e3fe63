"""The port's RWKV6 slice against the JAX package, on the CPU.

The WKV recurrence (the plain version, the CPU path of the port's kernel
wrapper) against the JAX oracle ``wkv6_ref``, the Pallas kernel ``wkv6``
(interpret mode, as tests/test_kernels.py runs it) and the model's chunked
form ``wkv_chunked``, with and without an initial state, and the one-token
step against ``wkv_step``; then ``time_mix`` and ``channel_mix``; then
reduced ``rwkv6-3b`` with ``compute_dtype="float32"`` and JAX params carried
through ``params_from_numpy``: forward logits, prefill logits and cache,
8 decode steps and the greedy tokens of ``ServingLoop.serve``.

Tolerances and their reasons: the WKV forms compute one recurrence in fp32
and differ in summation order (chunks of 16 or 64 against token by token),
so they are held at the JAX package's own WKV tolerances
(tests/test_kernels.py): 5e-4 in fp32, 5e-2 where r, k, v and y are bf16,
plus one bf16 step (2**-7 relative) on a bf16 y: each side rounds the same
fp32 sum once, a sum on a rounding boundary lands one step apart (half a
step against the fp32 y of the chunked form), and at |y| >= 8 (D 64 reaches
~12) a step exceeds 5e-2.  The layers
and the model keep the dense slice's tolerances (tests/test_torch_serve.py):
fp32 only up to the logits, 1e-4; decode 3e-3, since the shift states are
bf16 in the cache on both sides and one of them may round the other way.
Greedy tokens must be identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_reduced
from repro.kernels.rwkv6_wkv import wkv6 as pallas_wkv6
from repro.kernels.rwkv6_wkv import wkv6_ref as jax_wkv6_ref
from repro.models import build_model as jax_build
from repro.models import rwkv as jrk
from repro.models.common import init_params as jax_init
from repro.serve.decode import ServeConfig as JServeConfig
from repro.serve.decode import ServingLoop as JServingLoop
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels.rwkv6_wkv import wkv6
from repro_torch.kernels.rwkv6_wkv.kernel import wkv6_fwd
from repro_torch.models import build_model
from repro_torch.models import rwkv as trk
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.decode import ServeConfig, ServingLoop

ARCH = "rwkv6-3b"
B, S, STEPS, NEW = 2, 32, 8, 8
LOGIT_TOL = 1e-4
DECODE_TOL = 3e-3
WKV_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
Y_RTOL = {"float32": 0.0, "bfloat16": 2 ** -7}      # one bf16 step of y
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _wkv_inputs(S_, D, dtype, seed=0, Bn=2, H=3, state=False):
    """r, k, v ~ 0.5 N(0,1) in dtype, w_log = -exp(N(0,1)) fp32, u ~ N(0,1)
    fp32 (as tests/test_kernels.py draws them; the model's w_log is fp32),
    and optionally a state ~ 0.5 N(0,1): (JAX arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    shape = (Bn, S_, H, D)
    arrs = [0.5 * rng.standard_normal(shape) for _ in range(3)]
    arrs.append(-np.exp(rng.standard_normal(shape)))
    arrs.append(rng.standard_normal((H, D)))
    if state:
        arrs.append(0.5 * rng.standard_normal((Bn, H, D, D)))
    arrs = [a.astype(np.float32) for a in arrs]
    jdt, tdt = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in arrs[:3]] + \
        [jnp.asarray(a) for a in arrs[3:]]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs[:3]] + \
        [torch.from_numpy(a) for a in arrs[3:]]
    return jx, tx


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=rtol)


# ------------------------------------------------------------------ configs
def test_rwkv_config_matches_jax():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(get_reduced_config(ARCH)) == \
        dataclasses.asdict(jax_reduced(ARCH))


def test_rwkv_param_specs_match_jax():
    for jc, tc in ((jax_get_config(ARCH), get_config(ARCH)),
                   (jax_reduced(ARCH), get_reduced_config(ARCH))):
        jl = jax.tree_util.tree_flatten_with_path(
            jax_build(jc).param_specs(), is_leaf=lambda x: hasattr(x, "axes"))
        tl = jax.tree_util.tree_flatten_with_path(
            build_model(tc).param_specs(),
            is_leaf=lambda x: hasattr(x, "axes"))
        assert [(jax.tree_util.keystr(p), tuple(s)) for p, s in jl[0]] == \
            [(jax.tree_util.keystr(p), tuple(s)) for p, s in tl[0]]


def test_rwkv6_3b_size():
    """32 layers, 40 heads of 64, about 3.1 B parameters (6.2 GB in bf16):
    one card."""
    model = build_model(get_config(ARCH))
    assert trk.rwkv_dims(model.cfg) == (40, 64)
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        model.param_specs(), is_leaf=lambda x: hasattr(x, "axes")))
    assert 3.0e9 < n < 3.2e9


# --------------------------------------------------------------------- WKV6
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_", [1, 16, 64, 130])
def test_wkv_plain_matches_jax(S_, dtype, D):
    """From zero state: the JAX oracle, the Pallas kernel and the model's
    chunked form."""
    (jr, jk, jv, jw, ju), tx = _wkv_inputs(S_, D, dtype, seed=S_ + D)
    y, st = wkv6(*tx)
    assert y.dtype == tx[0].dtype and y.shape == tx[0].shape
    assert st.dtype == torch.float32 and st.shape == (2, 3, D, D)
    tol = WKV_TOL[dtype]
    for y_ref, st_ref in (jax_wkv6_ref(jr, jk, jv, jw, ju),
                          pallas_wkv6(jr, jk, jv, jw, ju),
                          jrk.wkv_chunked(jr, jk, jv, jw, ju)):
        _close(y, y_ref, tol, Y_RTOL[dtype])
        _close(st, st_ref, tol)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_", [1, 40])
def test_wkv_plain_from_a_state_matches_jax(S_, dtype, D):
    """From a given state (prefill from a cache, decode from the carried
    state): the JAX oracle and the chunked form; at S = 1 also the exact
    one-token step the JAX model decodes with."""
    (jr, jk, jv, jw, ju, js), tx = _wkv_inputs(S_, D, dtype, seed=7 + S_,
                                               state=True)
    y, st = wkv6(*tx)
    tol = WKV_TOL[dtype]
    refs = [jax_wkv6_ref(jr, jk, jv, jw, ju, state=js),
            jrk.wkv_chunked(jr, jk, jv, jw, ju, state=js)]
    if S_ == 1:
        ys, ss = jrk.wkv_step(jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], ju, js)
        refs.append((ys[:, None], ss))
    for y_ref, st_ref in refs:
        _close(y, y_ref, tol, Y_RTOL[dtype])
        _close(st, st_ref, tol)
    # the state is an input: the plain version leaves it as it was
    np.testing.assert_array_equal(tx[5].numpy(), np.asarray(js))


def test_wkv_kernel_wrapper_rejects_cpu_tensors():
    _, tx = _wkv_inputs(4, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_fwd(*tx)


# --------------------------------------------------------- time/channel mix
def _layer_params(cfg, specs, seed):
    """One layer's params from numpy: every leaf random (the JAX init's
    zero and one vectors would leave the token-shift mixes untested), u
    and w0 of unit and half scale as the model sees them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in specs.items():
        scale = 1.0 if name == "u" else (
            0.5 if len(spec.shape) == 1 else 1 / np.sqrt(spec.shape[-2]))
        out[name] = (scale * rng.standard_normal(spec.shape)).astype(
            np.float32)
    return out


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S_", [1, 12])
def test_time_mix_matches_jax(S_, carried):
    jc = jax_reduced(ARCH).replace(compute_dtype="float32")
    tc = get_reduced_config(ARCH).replace(compute_dtype="float32")
    jp, tp = _both(_layer_params(jc, jrk.time_mix_specs(jc), seed=3))
    H, D = trk.rwkv_dims(tc)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S_, tc.d_model)).astype(np.float32)
    shift = wkv_state = None
    if carried:
        shift = rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
        wkv_state = (0.5 * rng.standard_normal((B, H, D, D))).astype(
            np.float32)
    out, sh, st = trk.time_mix(
        tc, tp, torch.from_numpy(x),
        None if shift is None else torch.from_numpy(shift),
        None if wkv_state is None else torch.from_numpy(wkv_state))
    j_out, j_sh, j_st = jax.jit(functools.partial(jrk.time_mix, jc))(
        jp, jnp.asarray(x), None if shift is None else jnp.asarray(shift),
        None if wkv_state is None else jnp.asarray(wkv_state))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(j_sh))
    np.testing.assert_allclose(st.numpy(), np.asarray(j_st),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S_", [1, 12])
def test_channel_mix_matches_jax(S_, carried):
    jc = jax_reduced(ARCH).replace(compute_dtype="float32")
    tc = get_reduced_config(ARCH).replace(compute_dtype="float32")
    jp, tp = _both(_layer_params(jc, jrk.channel_mix_specs(jc), seed=5))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S_, tc.d_model)).astype(np.float32)
    shift = (rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
             if carried else None)
    out, sh = trk.channel_mix(
        tc, tp, torch.from_numpy(x),
        None if shift is None else torch.from_numpy(shift))
    j_out, j_sh = jax.jit(functools.partial(jrk.channel_mix, jc))(
        jp, jnp.asarray(x), None if shift is None else jnp.asarray(shift))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(j_sh))


# ---------------------------------------------------------------- parameters
def test_u_stays_float32_in_bfloat16_model():
    """The JAX code reads u in fp32 (rwkv.py wkv_chunked / wkv_step); a bf16
    u would round the bonus of every token.  The other RWKV matrices take
    the compute dtype; vectors stay fp32."""
    jc, tc = jax_reduced(ARCH), get_reduced_config(ARCH)
    assert tc.compute_dtype == "bfloat16"
    model = build_model(tc)
    tree = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32), jax_build(jc).param_specs(),
        is_leaf=lambda x: hasattr(x, "axes"))
    for params in (params_from_numpy(tree, model, "cpu"),
                   model.init_params(torch.Generator().manual_seed(0), "cpu")):
        assert len(params["layers"]) == tc.n_layers
        for lp in params["layers"]:
            assert lp["tm"]["u"].dtype == torch.float32
            for name in ("maa", "tm_w1", "tm_w2", "wr", "wk", "wv", "wg",
                         "wo", "w1", "w2"):
                assert lp["tm"][name].dtype == torch.bfloat16, name
            for name in ("wk", "wv", "wr"):
                assert lp["cm"][name].dtype == torch.bfloat16, name
            for name in ("maa_x", "w0", "ln_x_w", "ln_x_b"):
                assert lp["tm"][name].dtype == torch.float32, name
            assert lp["ln1"]["w"].dtype == torch.float32
        assert params["embed"].dtype == torch.bfloat16
        assert params["lm_head"].dtype == torch.bfloat16
        assert params["ln0"]["w"].dtype == torch.float32


# ---------------------------------------------------------- the served path
def _cfgs():
    return (jax_reduced(ARCH).replace(compute_dtype="float32"),
            get_reduced_config(ARCH).replace(compute_dtype="float32"))


def _prompts(cfg, n=B, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX forward, prefill + STEPS decode steps + served tokens, as numpy."""
    jc, _ = _cfgs()
    model = jax_build(jc)
    params = jax_init(model.param_specs(), jax.random.PRNGKey(0))
    toks = _prompts(jc)
    fwd, _ = jax.jit(model.forward)(params, {"tokens": toks})
    logits, cache = jax.jit(model.prefill)(params, {"tokens": toks})
    out = {"forward": np.asarray(fwd), "prefill": np.asarray(logits),
           "cache": {k: np.asarray(v) if k == "wkv" else
                     np.asarray(v, np.float32) for k, v in cache.items()
                     if k != "pos"},
           "decode": []}
    step = jax.jit(model.decode_step)
    feed = np.random.default_rng(1).integers(0, jc.vocab_size, (B, STEPS))
    for t in range(STEPS):
        logits, cache = step(params, feed[:, t:t + 1].astype(np.int32), cache)
        out["decode"].append(np.asarray(logits))
    loop = JServingLoop(model, params, B, S, JServeConfig(max_new_tokens=NEW))
    out["served"] = loop.serve(toks)
    return params, out, feed


def _port(params):
    _, tc = _cfgs()
    model = build_model(tc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return model, params_from_numpy(tree, model, "cpu")


def test_rwkv_forward_logits_match_jax():
    params, ref, _ = _jax_run()
    model, tp = _port(params)
    logits, aux = model.forward(
        tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
    np.testing.assert_allclose(logits.numpy(), ref["forward"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert float(aux) == 0.0


def test_rwkv_prefill_logits_and_cache_match_jax():
    params, ref, _ = _jax_run()
    model, tp = _port(params)
    logits, cache = model.prefill(
        tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert cache["pos"] == S
    for name in ("tm_shift", "cm_shift"):
        assert all(t.dtype == torch.bfloat16 for t in cache[name])
        got = torch.stack(cache[name]).float().numpy()
        # the same fp32 value rounded to bf16 on both sides, unless fp32
        # summation order puts it on the other side of a boundary: one step
        np.testing.assert_allclose(got, ref["cache"][name], atol=1e-6,
                                   rtol=2 ** -7)
    assert all(t.dtype == torch.float32 for t in cache["wkv"])
    np.testing.assert_allclose(torch.stack(cache["wkv"]).numpy(),
                               ref["cache"]["wkv"], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_rwkv_decode_logits_match_jax():
    params, ref, feed = _jax_run()
    model, tp = _port(params)
    with torch.inference_mode():
        _, cache = model.prefill(
            tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
        for t in range(STEPS):
            logits, cache = model.decode_step(
                tp, torch.from_numpy(feed[:, t:t + 1]).long(), cache)
            np.testing.assert_allclose(logits.numpy(), ref["decode"][t],
                                       atol=DECODE_TOL, rtol=0)
    assert cache["pos"] == S + STEPS


def test_rwkv_served_greedy_tokens_identical_to_jax():
    params, ref, _ = _jax_run()
    model, tp = _port(params)
    loop = ServingLoop(model, tp, B, S, ServeConfig(max_new_tokens=NEW),
                       device="cpu")
    np.testing.assert_array_equal(loop.serve(_prompts(model.cfg)),
                                  ref["served"])
