"""The port's MoE slice against the JAX package, on the CPU.

Reduced ``deepseek-v3-16b`` (sigmoid router) and ``deepseek-moe-16b``
(softmax router) with ``compute_dtype="float32"``: routing, capacity,
dispatch/combine (with forced drops) and the MoE block on the same numpy
inputs, then the served path as ``tests/test_torch_serve.py`` holds the
dense family: JAX params through ``params_from_numpy``, prefill logits and
the bf16 KV cache, 8 decode steps and the greedy tokens of
``ServingLoop.serve``, under both of JAX's attention paths.

Tolerances and their reasons: routing on identical fp32 logits picks the
same experts, and gates and aux agree to fp32 rounding (1e-6).  The MoE block
in fp32 sums in another order (the combine adds a token's k contributions in
top-k order, JAX's scatter in expert order): 1e-5.  The served path keeps
the dense tolerances (prefill 1e-4, cache one bf16 step, decode 3e-3).  A
top-k choice could flip where the k-th and (k+1)-th scores are within fp32
summation noise; every routing call of the served tests records that gap and
the test asserts it exceeds 1e-5 at the seed used, so a flip would show as a
clear failure rather than as noise.
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
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.models.attention import set_attention_impl
from repro.models.common import init_params as jax_init
from repro.serve.decode import ServeConfig as JServeConfig
from repro.serve.decode import ServingLoop as JServingLoop
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.decode import ServeConfig, ServingLoop

ARCHS = ["deepseek-v3-16b", "deepseek-moe-16b"]
IMPLS = ["chunked", "pallas"]
B, S, STEPS, NEW = 2, 32, 8, 8
LOGIT_TOL = 1e-4
DECODE_TOL = 3e-3
BLOCK_TOL = 1e-5
GAP = 1e-5


@pytest.fixture(autouse=True)
def _restore_attention_impl():
    """set_attention_impl is process-global; leave the default behind."""
    yield
    set_attention_impl("chunked")


@pytest.fixture
def route_gaps(monkeypatch):
    """Record, for every routing call of the port, the least gap between
    the k-th and (k+1)-th router score of any token."""
    gaps = []
    route = tmoe._route

    def recording(cfg, logits):
        m = cfg.moe
        scores = (torch.sigmoid(logits) if m.router == "sigmoid"
                  else torch.softmax(logits, -1))
        top = torch.topk(scores, m.top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(cfg, logits)

    monkeypatch.setattr(tmoe, "_route", recording)
    return gaps


def _cfgs(arch, **moe_kw):
    jc = jax_reduced(arch).replace(compute_dtype="float32")
    tc = get_reduced_config(arch).replace(compute_dtype="float32")
    if moe_kw:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


def _prompts(cfg, n=B, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, S)).astype(np.int32)


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32)))
            for k, v in tree.items()}


def _moe_params(jc, seed=0):
    """One MoE layer's params from the JAX initializer, as numpy."""
    p = jax_init(jmoe.moe_specs(jc), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == \
        dataclasses.asdict(jax_reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_specs_match_jax(arch):
    jc, tc = _cfgs(arch)
    jl = jax.tree_util.tree_flatten_with_path(
        jax_build(jc).param_specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
    tl = jax.tree_util.tree_flatten_with_path(
        build_model(tc).param_specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
    assert [(jax.tree_util.keystr(p), tuple(s)) for p, s in jl] == \
        [(jax.tree_util.keystr(p), tuple(s)) for p, s in tl]


def test_layer_split_follows_groups():
    """deepseek-v3-16b: layer 0 dense in g0, layers 1-27 MoE in g1."""
    model = build_model(get_config("deepseek-v3-16b"))
    assert model.layer_groups() == [(1, True), (27, False)]
    assert model.dense_layers == [True] + [False] * 27
    specs = model.param_specs()
    assert specs["g0"]["ffn"]["wg"].shape == (1, 2048, 10944)
    assert specs["g1"]["ffn"]["wg"].shape == (27, 64, 2048, 1408)
    assert specs["g1"]["ffn"]["router"].shape == (27, 2048, 64)


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    """Full-width router (64 experts, top-6) on identical fp32 logits."""
    cfg = get_config(arch)
    k = cfg.moe.top_k
    logits = np.random.default_rng(5).standard_normal((256, 64)).astype(
        np.float32)
    scores = (1 / (1 + np.exp(-logits)) if cfg.moe.router == "sigmoid"
              else np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    top = -np.sort(-scores, axis=-1)
    assert (top[:, k - 1] - top[:, k]).min() > GAP   # no near-tie at seed 5
    jg, ji, ja = jmoe._route(jax_get_config(arch), jnp.asarray(logits))
    tg, ti, ta = tmoe._route(cfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    assert tg.dtype == torch.float32 and ti.shape == (256, k)


@pytest.mark.parametrize("n_tokens", [1, 4, 8, 64, 2048, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, n_tokens):
    for jc, tc in ((jax_get_config(arch), get_config(arch)), _cfgs(arch)):
        assert tmoe.capacity(tc, n_tokens) == jmoe.capacity(jc, n_tokens)
        assert tmoe.capacity(tc, n_tokens) % 8 == 0


def test_capacity_at_serving_shapes():
    """deepseek-v3-16b at batch 4, prompt 512: C 240 in prefill (T 2048),
    8 in decode (T 4)."""
    cfg = get_config("deepseek-v3-16b")
    assert tmoe.capacity(cfg, 4 * 512) == 240
    assert tmoe.capacity(cfg, 4) == 8


# ------------------------------------------------------ dispatch and combine
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_combine_matches_jax_with_drops(arch):
    """capacity_factor 0.5 (as tests/test_integration.py) forces tokens
    past capacity into the trash slot."""
    jc, tc = _cfgs(arch, capacity_factor=0.5)
    p = _moe_params(jc)
    rng = np.random.default_rng(1)
    T = 48
    xs = rng.standard_normal((T, jc.d_model)).astype(np.float32)
    logits = rng.standard_normal((T, jc.moe.n_experts)).astype(np.float32)
    jg, ji, _ = jmoe._route(jc, jnp.asarray(logits))
    counts = np.bincount(np.asarray(ji).ravel(), minlength=jc.moe.n_experts)
    assert counts.max() > tmoe.capacity(tc, T)          # some are dropped
    ref = jmoe._dispatch_combine_local(jc, p, jnp.asarray(xs), jg, ji)
    got = tmoe._dispatch_combine_local(
        tc, _torch_tree(p), torch.from_numpy(xs),
        torch.from_numpy(np.array(jg)), torch.from_numpy(np.array(ji)).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch):
    jc, tc = _cfgs(arch)
    p = _moe_params(jc, seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    ref, ref_aux = jmoe.moe_forward(jc, p, jnp.asarray(x))
    got, aux = tmoe.moe_forward(tc, _torch_tree(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-6)


# ---------------------------------------------------------------- parameters
def test_router_stays_float32_in_bfloat16_model():
    """The JAX model routes from fp32 params in fp32; a bf16 router would
    route otherwise.  Expert and shared matrices take the compute dtype."""
    jc = jax_reduced("deepseek-v3-16b")
    tc = get_reduced_config("deepseek-v3-16b")
    assert tc.compute_dtype == "bfloat16"
    model = build_model(tc)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init(jax_build(jc).param_specs(),
                             jax.random.PRNGKey(0)))
    for params in (params_from_numpy(tree, model, "cpu"),
                   model.init_params(torch.Generator().manual_seed(0), "cpu")):
        moe_layers = [lp["ffn"] for lp, dense in
                      zip(params["layers"], model.dense_layers) if not dense]
        assert moe_layers
        for f in moe_layers:
            assert f["router"].dtype == torch.float32
            for name in ("wg", "wu", "wd"):
                assert f[name].dtype == torch.bfloat16
                assert f["shared"][name].dtype == torch.bfloat16
        assert params["layers"][0]["ffn"]["wg"].dtype == torch.bfloat16
        assert params["layers"][0]["ln1"]["w"].dtype == torch.float32


# ---------------------------------------------------------- the served path
@functools.lru_cache(maxsize=None)
def _jax_run(arch, impl):
    """JAX forward, prefill + STEPS decode steps + served tokens, as numpy."""
    jc, _ = _cfgs(arch)
    set_attention_impl(impl)
    try:
        model = jax_build(jc, max_cache_len=S + STEPS)
        params = jax_init(model.param_specs(), jax.random.PRNGKey(0))
        toks = _prompts(jc)
        fwd, aux = jax.jit(model.forward)(params, {"tokens": toks})
        logits, cache = jax.jit(model.prefill)(params, {"tokens": toks})
        out = {"forward": np.asarray(fwd), "aux": float(aux),
               "prefill": np.asarray(logits),
               "k": np.asarray(cache["k"], np.float32),
               "v": np.asarray(cache["v"], np.float32), "decode": []}
        step = jax.jit(model.decode_step)
        feed = np.random.default_rng(1).integers(0, jc.vocab_size, (B, STEPS))
        for t in range(STEPS):
            logits, cache = step(params, feed[:, t:t + 1].astype(np.int32),
                                 cache)
            out["decode"].append(np.asarray(logits))
        loop = JServingLoop(model, params, B, S,
                            JServeConfig(max_new_tokens=NEW))
        out["served"] = loop.serve(toks)
        return params, out, feed
    finally:
        set_attention_impl("chunked")


def _port(arch, params):
    _, tc = _cfgs(arch)
    model = build_model(tc, max_cache_len=S + STEPS)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return model, params_from_numpy(tree, model, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_logits_and_aux_match_jax(arch, route_gaps):
    params, ref, _ = _jax_run(arch, "chunked")
    model, tp = _port(arch, params)
    logits, aux = model.forward(
        tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
    np.testing.assert_allclose(logits.numpy(), ref["forward"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), ref["aux"], atol=1e-6)
    assert float(aux) > 0
    assert len(route_gaps) == 3 and min(route_gaps) > GAP


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_logits_and_cache_match_jax(arch, impl, route_gaps):
    params, ref, _ = _jax_run(arch, impl)
    model, tp = _port(arch, params)
    logits, cache = model.prefill(
        tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert cache["pos"] == S and cache["k"][0].dtype == torch.bfloat16
    for name in ("k", "v"):
        got = torch.stack(cache[name]).float().numpy()
        np.testing.assert_allclose(got, ref[name], atol=1e-6, rtol=2 ** -7)
    assert min(route_gaps) > GAP


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_logits_match_jax(arch, impl, route_gaps):
    params, ref, feed = _jax_run(arch, impl)
    model, tp = _port(arch, params)
    with torch.inference_mode():
        _, cache = model.prefill(
            tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
        for t in range(STEPS):
            logits, cache = model.decode_step(
                tp, torch.from_numpy(feed[:, t:t + 1]).long(), cache)
            np.testing.assert_allclose(logits.numpy(), ref["decode"][t],
                                       atol=DECODE_TOL, rtol=0)
    assert cache["pos"] == S + STEPS
    assert len(route_gaps) == 3 * (1 + STEPS) and min(route_gaps) > GAP


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_served_greedy_tokens_identical_to_jax(arch, impl, route_gaps):
    params, ref, _ = _jax_run(arch, impl)
    model, tp = _port(arch, params)
    loop = ServingLoop(model, tp, B, S, ServeConfig(max_new_tokens=NEW),
                       device="cpu")
    np.testing.assert_array_equal(loop.serve(_prompts(model.cfg)),
                                  ref["served"])
    assert min(route_gaps) > GAP
