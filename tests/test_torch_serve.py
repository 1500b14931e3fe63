"""The port's serving slice against the JAX package, on the CPU.

Reduced ``llama3.1-8b``, ``qwen3-4b`` (qk-norm, tied embeddings),
``mistral-7b`` (a sliding window of 32: the cache of S + STEPS = 40 is a
ring of 32 slots, which the decode steps wrap), ``deepseek-7b`` (MHA),
``qwen2.5-32b`` (QKV bias) and ``nemotron-4-15b`` (LayerNorm, squared-ReLU
MLP) with ``compute_dtype="float32"``: JAX params go through ``params_from_numpy``;
prefill logits and the bf16 KV cache, 8 decode steps of logits and the
greedy tokens of ``ServingLoop.serve`` are compared with the JAX model under
both of its attention paths, ``"chunked"`` and ``"pallas"`` (interpret).

Both sides run fp32 with the same dtype flow (bf16 cache, softmax weights
and the attention output cast to the cache dtype in decode), so what differs
is fp32 summation order (~1e-6), and where that order puts a value on the
other side of a bf16 rounding boundary, one bf16 step (at most 2**-7
relative) in that value.  Hence: prefill logits 1e-4 (fp32 only up to the
logits); the bf16 cache one bf16 step; decode logits 3e-3, because one
flipped bf16 softmax weight or attention output moves every logit of its
row by up to ~1.3e-3 at these widths (steps without a flip agree to ~2e-6).
Greedy tokens must be identical.

Those two bf16 holds are the ones of the first two archs.  Every arch is
also held with a float32 cache on both sides, where prefill, the cache and
every decode step (the ring's too) are fp32 throughout: all at 1e-4.  The
one-step bf16 holds assume fp32 noise of ~1e-6 ahead of the rounding, which
the four later archs exceed at a few elements (1.1e-6 to 2.9e-6 on one
cache value near zero; 3.3e-3 to 3.7e-3 on decode logits, two or three
flipped bf16 values): with ``rope_theta`` 10,000, llama reads the same
2.9e-6, from XLA's and torch's fp32 cos and sin one ulp apart.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.models.attention import set_attention_impl
from repro.models.common import init_params as jax_init
from repro.models.common import apply_rope as jax_rope
from repro.models.common import layernorm as jax_layernorm
from repro.models.common import rmsnorm as jax_rmsnorm
from repro.models.common import rope_freqs as jax_freqs
from repro.serve.decode import ServeConfig as JServeConfig
from repro.serve.decode import ServingLoop as JServingLoop
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import (apply_rope, layernorm, rmsnorm,
                                       rope_freqs)
from repro_torch.serve.decode import ServeConfig, ServingLoop

ARCHS = ["llama3.1-8b", "qwen3-4b", "mistral-7b", "deepseek-7b",
         "qwen2.5-32b", "nemotron-4-15b"]
# the archs whose bf16 cache and bf16-cache decode logits are held at the
# one-bf16-step tolerances below; every arch is held with a float32 cache
# (test_float32_cache_prefill_and_decode_match_jax)
BF16_CACHE_ARCHS = ["llama3.1-8b", "qwen3-4b"]
IMPLS = ["chunked", "pallas"]
B, S, STEPS, NEW = 2, 32, 8, 8
LOGIT_TOL = 1e-4
DECODE_TOL = 3e-3


@pytest.fixture(autouse=True)
def _restore_attention_impl():
    """set_attention_impl is process-global; leave the default behind."""
    yield
    set_attention_impl("chunked")


def _cfgs(arch):
    jc = jax_reduced(arch).replace(compute_dtype="float32")
    tc = get_reduced_config(arch).replace(compute_dtype="float32")
    return jc, tc


def _prompts(cfg, n=B, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, impl, cache_len, cache_dtype=None):
    """JAX prefill + STEPS decode steps + served tokens, as numpy.  With
    ``cache_dtype`` the prefill fills a cache of that dtype (cache_len slots,
    a ring of the window for mistral) and nothing is served."""
    jc, _ = _cfgs(arch)
    set_attention_impl(impl)
    try:
        model = jax_build(jc, max_cache_len=cache_len)
        params = jax_init(model.param_specs(), jax.random.PRNGKey(0))
        toks = _prompts(jc)
        cache = None if cache_dtype is None else model.init_cache(
            B, cache_dtype)
        logits, cache = jax.jit(model.prefill)(params, {"tokens": toks},
                                               cache)
        out = {"prefill": np.asarray(logits),
               "k": np.asarray(cache["k"], np.float32),
               "v": np.asarray(cache["v"], np.float32), "decode": []}
        step = jax.jit(model.decode_step)
        feed = np.random.default_rng(1).integers(0, jc.vocab_size, (B, STEPS))
        if cache_len >= S + STEPS:
            for t in range(STEPS):
                logits, cache = step(params, feed[:, t:t + 1].astype(np.int32),
                                     cache)
                out["decode"].append(np.asarray(logits))
            if cache_dtype is None:
                loop = JServingLoop(model, params, B, S,
                                    JServeConfig(max_new_tokens=NEW))
                out["served"] = loop.serve(toks)
        return params, out, feed
    finally:
        set_attention_impl("chunked")


def _port(arch, params, cache_len):
    _, tc = _cfgs(arch)
    model = build_model(tc, max_cache_len=cache_len)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return model, params_from_numpy(tree, model, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == \
        dataclasses.asdict(jax_reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    jc, tc = _cfgs(arch)
    jspecs = jax_build(jc).param_specs()
    tspecs = build_model(tc).param_specs()
    jl = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    tl = jax.tree_util.tree_flatten_with_path(
        tspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    assert [(jax.tree_util.keystr(p), tuple(s)) for p, s in jl] == \
        [(jax.tree_util.keystr(p), tuple(s)) for p, s in tl]


def test_bridge_rejects_wrong_shape():
    jc, tc = _cfgs("llama3.1-8b")
    model = build_model(tc)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init(jax_build(jc).param_specs(),
                             jax.random.PRNGKey(0)))
    tree["g0"]["attn"]["wq"] = tree["g0"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="g0/attn/wq"):
        params_from_numpy(tree, model, "cpu")


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    np.testing.assert_allclose(rmsnorm(tx, tw).numpy(),
                               np.asarray(jax_rmsnorm(x, w)), atol=2e-6)
    np.testing.assert_allclose(layernorm(tx, tw, tb).numpy(),
                               np.asarray(jax_layernorm(x, w, b)), atol=2e-6)
    pos = np.arange(5, dtype=np.int32) + 100
    cos, sin = rope_freqs(torch.from_numpy(pos), 16, 500_000.0)
    jcos, jsin = jax_freqs(pos, 16, 500_000.0)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jax_rope(x, jcos, jsin)), atol=2e-5)


def test_init_params_follow_specs():
    """Matrices in the compute dtype at 1/sqrt(fan_in), embeddings at 0.02,
    norm weights ones in fp32; the same seed gives the same weights."""
    cfg = get_reduced_config("llama3.1-8b").replace(d_model=256, d_ff=512)
    model = build_model(cfg)
    p = model.init_params(torch.Generator().manual_seed(0), "cpu")
    lp = p["layers"][1]
    assert lp["attn"]["wq"].dtype == torch.bfloat16
    assert abs(float(lp["ffn"]["wd"].float().std()) * 512 ** 0.5 - 1) < 0.02
    assert abs(float(p["embed"].float().std()) / 0.02 - 1) < 0.02
    assert lp["ln1"]["w"].dtype == torch.float32
    assert bool((lp["ln1"]["w"] == 1).all())
    again = model.init_params(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"][1]["attn"]["wq"], lp["attn"]["wq"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    params, _, _ = _jax_run(arch, "chunked", S + STEPS)
    jc, _ = _cfgs(arch)
    toks = _prompts(jc)
    ref, _ = jax.jit(jax_build(jc).forward)(params, {"tokens": toks})
    model, tp = _port(arch, params, S + STEPS)
    logits, aux = model.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("cache_len", [S + STEPS, S])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", BF16_CACHE_ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, impl, cache_len):
    """cache_len == S takes the ring-slot branch of prefill."""
    params, ref, _ = _jax_run(arch, impl, cache_len)
    model, tp = _port(arch, params, cache_len)
    logits, cache = model.prefill(
        tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert cache["pos"] == S and cache["k"][0].dtype == torch.bfloat16
    for name in ("k", "v"):
        got = torch.stack(cache[name]).float().numpy()
        np.testing.assert_allclose(got, ref[name], atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", BF16_CACHE_ARCHS)
def test_decode_logits_match_jax(arch, impl):
    params, ref, feed = _jax_run(arch, impl, S + STEPS)
    model, tp = _port(arch, params, S + STEPS)
    with torch.inference_mode():
        _, cache = model.prefill(
            tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()})
        for t in range(STEPS):
            logits, cache = model.decode_step(
                tp, torch.from_numpy(feed[:, t:t + 1]).long(), cache)
            np.testing.assert_allclose(logits.numpy(), ref["decode"][t],
                                       atol=DECODE_TOL, rtol=0)
    assert cache["pos"] == S + STEPS


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_float32_cache_prefill_and_decode_match_jax(arch, impl):
    """Prefill logits, the cache and STEPS decode logits with a float32
    cache on both sides (mistral's a ring of 32 slots that the steps wrap):
    fp32 throughout, so all within LOGIT_TOL."""
    params, ref, feed = _jax_run(arch, impl, S + STEPS,
                                 jax.numpy.float32)
    model, tp = _port(arch, params, S + STEPS)
    assert model.cache_window == (model.cfg.window or S + STEPS)
    with torch.inference_mode():
        logits, cache = model.prefill(
            tp, {"tokens": torch.from_numpy(_prompts(model.cfg)).long()},
            model.init_cache(B, "cpu", torch.float32))
        np.testing.assert_allclose(logits.numpy(), ref["prefill"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(torch.stack(cache[name]).numpy(),
                                       ref[name], atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
        for t in range(STEPS):
            logits, cache = model.decode_step(
                tp, torch.from_numpy(feed[:, t:t + 1]).long(), cache)
            np.testing.assert_allclose(logits.numpy(), ref["decode"][t],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert cache["pos"] == S + STEPS


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_served_greedy_tokens_identical_to_jax(arch, impl):
    params, ref, _ = _jax_run(arch, impl, S + STEPS)
    model, tp = _port(arch, params, S + STEPS)
    loop = ServingLoop(model, tp, B, S, ServeConfig(max_new_tokens=NEW),
                       device="cpu")
    np.testing.assert_array_equal(loop.serve(_prompts(model.cfg)),
                                  ref["served"])


def test_serving_loop_static_shape_checks():
    _, tc = _cfgs("qwen3-4b")
    model = build_model(tc, max_cache_len=S + 2)
    tp = model.init_params(torch.Generator().manual_seed(0), "cpu")
    loop = ServingLoop(model, tp, B, S, ServeConfig(max_new_tokens=2),
                       device="cpu")
    with pytest.raises(ValueError, match="static shapes"):
        loop.serve(np.zeros((1, S + 1), np.int32))
    with pytest.raises(ValueError, match="exceeds batch_size"):
        loop.serve(np.zeros((B + 1, S), np.int32))
    out = loop.serve(_prompts(tc, n=1))
    assert out.shape == (1, 2)


def test_sampling_with_temperature_is_seeded():
    _, tc = _cfgs("llama3.1-8b")
    model = build_model(tc, max_cache_len=S + 4)
    tp = model.init_params(torch.Generator().manual_seed(0), "cpu")
    cfg = ServeConfig(max_new_tokens=4, temperature=1.0, seed=7)
    runs = [ServingLoop(model, tp, B, S, cfg, device="cpu").serve(
        _prompts(tc)) for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < tc.vocab_size)).all()


@pytest.mark.parametrize("arch,item", [
    ("grok-1-314b", "item 13b"), ("hymba-1.5b", "item 16"),
    ("whisper-medium", "item 18"), ("llama-3.2-vision-90b", "item 18")])
def test_unported_archs_and_families_raise(arch, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1, {item}"):
        get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(get_reduced_config("llama3.1-8b").replace(family="hybrid"))
