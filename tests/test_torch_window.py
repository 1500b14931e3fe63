"""The port's sliding window (``mistral-7b``) against the JAX package and
against itself, on the CPU.

* The ring KV cache, a mirror of ``tests/test_decode_consistency.py:57``:
  reduced fp32 ``mistral-7b`` with a window of 8 and a cache of 48 slots
  asked for (so a ring of 8), a prompt of 32 (the prompt wraps the ring)
  or of 5 (the ring not yet full when decoding starts) and 8 decode steps
  teacher-forced from the sequence.  Each step's logits equal JAX's
  ring decode and the port's own ``forward`` logits at that position
  (which apply the window as a mask over the whole sequence), within 2e-5
  (the JAX package's fp32 tolerance, ``tests/test_kernels.py``); the cache
  is float32 on both sides, so nothing rounds to bf16.  The ring slots and
  the decode mask are held against the positions they must hold.
* Training at S > window: the loss, its metrics and every gradient leaf of
  reduced fp32 ``mistral-7b`` (window 8, S 48) against
  ``jax.value_and_grad`` of the JAX model, at ``tests/test_torch_train.py``'s
  tolerances; the window binds (the loss without it differs).  The Lit
  Silicon hook's simulated iteration clips attention to the arch's window.
* Sharded, over gloo at world 2 (one spawn): FSDP (mesh (2, 1)) and the
  (1, 2) mesh with sequence parallelism, whose ranks hold 16 of the 32
  positions each, twice the window, so that a query near a rank's first
  position sees keys of the other rank.  Each step's loss, CE, z-loss,
  token count and gradient norm, and every leaf's first-step gradient
  (gathered over both axes, relative to the leaf's largest), equal one
  process within 2e-5.

JAX is imported by the cases that compare with it only, so the spawned
processes, which import this module, start without it.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import ParallelConfig, TrainConfig
from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy, train_params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.parallel.mesh import make_host_mesh
from repro_torch.train.checkpoint import flatten_with_paths
from repro_torch.train.data import DataConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig
from test_torch_tensor_parallel import _free_port, _gathered_grads

ARCH = "mistral-7b"
WINDOW = 8
TOL = 2e-5                      # fp32 (tests/test_kernels.py)
METRICS = ("loss", "ce_loss", "z_loss", "tokens", "grad_norm")
SPAWN_TIMEOUT = 240.0


def _cfg(window=WINDOW):
    return get_reduced_config(ARCH).replace(compute_dtype="float32",
                                            window=window)


def _jax_cfg(window=WINDOW):
    from repro.configs import get_reduced_config as jax_reduced
    return jax_reduced(ARCH).replace(compute_dtype="float32", window=window)


def _rel_close(got, want, what):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= TOL, f"{what}: relative error {err:.3e} > {TOL}"


# --------------------------------------------------------------------------- #
# The ring KV cache
# --------------------------------------------------------------------------- #
B, PROMPT, STEPS, CACHE = 2, 32, 8, 48


@pytest.fixture(scope="module", params=[PROMPT, 5], ids=lambda p: f"prompt{p}")
def ring(request):
    """JAX's prefill and ring decode, and the port's, on the same params and
    tokens, with float32 caches; and the port's forward logits."""
    prompt = request.param
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build
    from repro.models.attention import set_attention_impl
    from repro.models.common import init_params as jax_init
    jc = _jax_cfg()
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (B, prompt + STEPS)).astype(np.int32)
    set_attention_impl("xla")            # as tests/test_decode_consistency
    try:
        jm = jax_build(jc, max_cache_len=CACHE)
        assert jm.cache_window == WINDOW
        jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0))
        lg, cache = jax.jit(jm.prefill)(
            jp, {"tokens": toks[:, :prompt]}, jm.init_cache(B, jnp.float32))
        jlogits = [np.asarray(lg)]
        step = jax.jit(jm.decode_step)
        for t in range(prompt, prompt + STEPS):
            lg, cache = step(jp, toks[:, t:t + 1], cache)
            jlogits.append(np.asarray(lg))
    finally:
        set_attention_impl("chunked")
    model = build_model(_cfg(), max_cache_len=CACHE)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), model,
                           "cpu")
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full, _ = model.forward(tp, {"tokens": tt})
        lg, tc = model.prefill(tp, {"tokens": tt[:, :prompt]},
                               model.init_cache(B, "cpu", torch.float32))
        tlogits, caches = [lg], [[c.clone() for c in tc["k"]]]
        for t in range(prompt, prompt + STEPS):
            lg, tc = model.decode_step(tp, tt[:, t:t + 1], tc)
            tlogits.append(lg)
            caches.append([c.clone() for c in tc["k"]])
    return dict(model=model, params=tp, tokens=tt, full=full, prompt=prompt,
                jax=jlogits, port=tlogits, caches=caches, pos=tc["pos"])


def test_ring_has_window_slots_and_decodes_past_its_length(ring):
    model = ring["model"]
    assert model.ring and model.cache_window == WINDOW
    assert ring["caches"][0][0].shape == (B, WINDOW, model.cfg.n_kv_heads,
                                          model.cfg.head_dim)
    assert ring["pos"] == ring["prompt"] + STEPS
    # past the 48 slots asked for: a ring does not run out
    cache = model.init_cache(1, "cpu", torch.float32)
    cache["pos"] = CACHE + 5
    with torch.inference_mode():
        lg, cache = model.decode_step(ring["params"], ring["tokens"][:1, :1],
                                      cache)
    assert cache["pos"] == CACHE + 6 and bool(torch.isfinite(lg).all())


def test_full_length_cache_still_raises_past_its_end(ring):
    model = build_model(_cfg(window=0), max_cache_len=PROMPT)
    assert not model.ring and model.cache_window == PROMPT
    cache = model.init_cache(1, "cpu", torch.float32)
    cache["pos"] = PROMPT
    with pytest.raises(ValueError, match="past the cache"):
        model.decode_step(ring["params"], ring["tokens"][:1, :1], cache)


def test_ring_slots_hold_the_latest_position_of_their_residue(ring):
    """After the prompt, slot s holds the key of position p == s (mod 8),
    the latest such p before the prompt's end (zeros where there is none
    yet); each decode step overwrites slot pos % 8."""
    tp, tt, prompt = ring["params"], ring["tokens"], ring["prompt"]
    # layer 0's key at every position, from a full-length cache (layer 0's
    # keys do not depend on the window)
    whole = build_model(_cfg(window=0), max_cache_len=prompt + STEPS)
    with torch.inference_mode():
        _, wc = whole.prefill(tp, {"tokens": tt},
                              whole.init_cache(B, "cpu", torch.float32))
    keys = wc["k"][0]                               # (B, 40, kvH, D)
    for n, cache in enumerate(ring["caches"]):
        last = prompt - 1 + n                       # the latest position
        for s in range(WINDOW):
            p = last - ((last - s) % WINDOW)
            want = keys[:, p] if p >= 0 else torch.zeros_like(keys[:, 0])
            torch.testing.assert_close(cache[0][:, s], want, atol=1e-6,
                                       rtol=1e-6)


def test_ring_decode_matches_jax_ring_decode(ring):
    for t, (got, want) in enumerate(zip(ring["port"], ring["jax"])):
        _rel_close(got, want, f"step {t}")
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_ring_decode_matches_forward_with_the_window_as_a_mask(ring):
    """Each decode step's logits (and the prefill's last) equal forward's at
    that position, where forward masks every key further back than the
    window; without the window forward differs there."""
    full, prompt = ring["full"], ring["prompt"]
    for n, got in enumerate(ring["port"]):
        pos = prompt - 1 + n
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, pos].numpy(),
                                   atol=TOL, rtol=TOL)
    model = build_model(_cfg(window=0))
    with torch.inference_mode():
        unwindowed, _ = model.forward(ring["params"],
                                      {"tokens": ring["tokens"]})
    assert float((unwindowed[:, WINDOW:] - full[:, WINDOW:]).abs().max()) \
        > 100 * TOL


# --------------------------------------------------------------------------- #
# Training at S > window, against JAX
# --------------------------------------------------------------------------- #
def _batch(vocab, B=2, S=48, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return toks, labels


def test_loss_and_every_gradient_past_the_window_match_jax():
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build
    from repro.models.common import init_params as jax_init
    jc = _jax_cfg()
    jm, tm = jax_build(jc), build_model(_cfg())
    jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0))
    toks, labels = _batch(jc.vocab_size)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = train_params_from_numpy(tree, tm, "cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    tl, tmet = tm.loss(tp, batch)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= TOL * max(1.0, abs(float(jl)))
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            TOL * max(1.0, abs(float(jmet[k]))), k
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    leaves = list(tree_leaves(tp))
    assert len(flat) == len(leaves)
    for (path, g), t in zip(flat, leaves):
        _rel_close(t.grad, g, jax.tree_util.keystr(path))
    # the window binds at S 48: the same model without it has another loss
    plain = build_model(_cfg(window=0))
    ul, _ = plain.loss(train_params_from_numpy(tree, plain, "cpu"), batch)
    assert abs(float(ul.detach()) - float(jl)) > 100 * TOL


def test_hook_workload_clips_attention_to_the_window():
    """The Lit Silicon hook's simulated iteration is built from the arch's
    config, window included: at S 8192 mistral's flash attention is that of
    4,096 keys a query, half the unwindowed; at the hook's own S 4096 the
    window does not bind; the hook takes the config it is given."""
    from repro_torch.configs import get_config
    from repro_torch.core.manager import ManagerConfig
    from repro_torch.core.workload import fsdp_llm_iteration
    from repro_torch.train.train_loop import LitSiliconHook
    cfg = get_config(ARCH)

    def attention_gflop(wl):
        return sum(k.gflop for k in wl.comp if k.name == "f_attn_fa")

    def at(c, seq):
        return attention_gflop(fsdp_llm_iteration(c, batch=1, seq=seq,
                                                  n_shards=8))
    assert at(cfg, 8192) == pytest.approx(at(cfg.replace(window=0), 8192) / 2)
    assert at(cfg, 4096) == at(cfg.replace(window=0), 4096)
    hook = LitSiliconHook(cfg, ManagerConfig(use_case="gpu-red"))
    assert attention_gflop(hook.node.sim.wl) == attention_gflop(
        fsdp_llm_iteration(cfg, batch=2, seq=4096, n_shards=8))


# --------------------------------------------------------------------------- #
# Sharded: FSDP and the (1, 2) mesh with sequence parallelism, over gloo
# --------------------------------------------------------------------------- #
SEQ = 32                        # 16 positions a rank under SP: twice WINDOW
JOBS = {"fsdp": 1, "mesh_sp": 2}        # name: model_parallel


def _config(directory):
    return TrainerConfig(
        model=_cfg(),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          grad_clip=1e9, checkpoint_every=0,
                          checkpoint_dir=str(directory)),
        parallel=ParallelConfig(sequence_parallel=True),
        data=DataConfig(global_batch=4, seq_len=SEQ))


def _worker(rank, world, port, root, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    logs = {}
    for name, m in JOBS.items():
        mesh = make_host_mesh(model_parallel=m, device="cpu")
        tr = Trainer(_config(os.path.join(root, name)), device="cpu",
                     mesh=mesh)
        tr.run(1)
        grads = _gathered_grads(tr)
        logs[name] = tr.run(2)
        logs[name + "/grads"] = grads
        logs[name + "/mesh"] = dict(tr.fsdp.mesh_shape)
        logs[name + "/seq"] = tr.fsdp.tp is not None and tr.fsdp.tp.seq
    torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save(logs, out)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("window")
    out = root / "w2.pt"
    ctx = mp.start_processes(_worker, args=(2, _free_port(), str(root),
                                            str(out)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"world 2 did not finish in {SPAWN_TIMEOUT} s")
    single = Trainer(_config(root / "single"), device="cpu")
    single.run(1)
    grads = {key: t.grad.detach().clone()
             for key, t in flatten_with_paths(single.state.params)}
    single.run(2)
    return torch.load(out), single.metrics_log, grads


@pytest.mark.parametrize("name", list(JOBS))
def test_sharded_window_matches_one_process(sharded, name):
    logs, want, grads = sharded
    assert logs[name + "/mesh"] == {"data": 2 // JOBS[name],
                                    "model": JOBS[name]}
    if name == "mesh_sp":       # the residual stream split over the sequence
        assert logs[name + "/seq"]
    got = logs[name]
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), \
                f"{name} step {i} {k}: {g[k]} vs {w[k]}"
    assert logs[name + "/grads"].keys() == grads.keys()
    for key, g in logs[name + "/grads"].items():
        _rel_close(g, grads[key].numpy(), f"{name} {key}")
