"""Decoder-only LM, dense and MoE families: forward, loss, prefill into a
KV cache, decode.

The torch counterpart of ``repro.models.transformer.DecoderOnlyLM``.  The
parameter tree keeps the JAX package's layout (``param_specs`` stacks the
layers of one structure along a leading axis, one group ``g<i>`` per entry
of ``layer_groups``: deepseek's first dense layer in ``g0``, its MoE layers
in ``g1``) so that parameters carry over path for path; at run time the
groups become one per-layer list (``split_layers``) walked by a Python loop
in place of ``lax.scan``.

``loss`` takes the JAX layout itself (float32 training parameters, stacked
groups as leaf tensors), splits it into per-layer views inside each call,
and runs every layer under one activation checkpoint
(``torch.utils.checkpoint``, non-reentrant: the layer's forward runs again
in the backward), the counterpart of the JAX package's
``jax.checkpoint(policy=nothing_saveable)`` around its scanned layer body.

The KV cache is a bf16 buffer per layer, written in place: full-length,
or, for a sliding-window model whose cache is longer than its window, a
ring of ``window`` slots (``cache_window``), as in the JAX package.
Hybrid (SSM) layers are a later slice of the port and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import (COMPUTE_DTYPES, ParamSpec, apply_norm,
                                       cross_entropy_loss, init_params,
                                       layer_views, norm_spec, pad_vocab,
                                       softcap, stack_specs, take_embedding,
                                       trainable)
from repro_torch.models.mlp import mlp
from repro_torch.models.moe import moe_forward, moe_or_mlp_specs


class DecoderOnlyLM:
    def __init__(self, cfg, *, max_cache_len: int = 0):
        if cfg.family not in ("dense", "moe") or cfg.ssm is not None:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet; "
                f"repro_torch runs the dense and MoE families "
                f"(ROADMAP.md §1)")
        if cfg.pos_embedding == "learned":
            raise NotImplementedError(f"{cfg.name}: learned positions are "
                                      f"not ported yet (ROADMAP.md §1)")
        self.cfg = cfg
        self.vp = pad_vocab(cfg.vocab_size)
        self.max_cache_len = max_cache_len or cfg.max_seq_len
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        # per layer: does it run a dense MLP (else the MoE block)
        self.dense_layers = [dense for n, dense in self.layer_groups()
                             for _ in range(n)]

    # ------------------------------------------------------------- structure
    def layer_groups(self) -> List[Tuple[int, bool]]:
        """[(n_layers, is_dense_mlp)] group split (moe first_k_dense)."""
        cfg = self.cfg
        if cfg.moe is not None and cfg.moe.first_k_dense:
            k = cfg.moe.first_k_dense
            return [(k, True), (cfg.n_layers - k, False)]
        return [(cfg.n_layers, cfg.moe is None)]

    def _block_specs(self, dense_mlp: bool) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_spec(cfg, cfg.d_model),
            "attn": attn.attn_specs(cfg),
            "ln2": norm_spec(cfg, cfg.d_model),
            "ffn": moe_or_mlp_specs(cfg, dense_mlp),
        }

    def param_specs(self) -> Dict[str, Any]:
        """The JAX package's spec tree, layers stacked per group ``g<i>``."""
        cfg = self.cfg
        s: Dict[str, Any] = {
            "embed": ParamSpec((self.vp, cfg.d_model), ("vocab", "embed"),
                               "embed"),
            "final_norm": norm_spec(cfg, cfg.d_model),
        }
        if not cfg.tie_embeddings:
            s["lm_head"] = ParamSpec((cfg.d_model, self.vp),
                                     ("embed", "vocab"))
        for gi, (n, dense) in enumerate(self.layer_groups()):
            s[f"g{gi}"] = stack_specs(self._block_specs(dense), n)
        return s

    def split_layers(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Stacked groups ``g<i>`` -> ``layers``: one list of per-layer trees
        (views), the groups in order."""
        groups = [f"g{gi}" for gi in range(len(self.layer_groups()))]
        out = {k: v for k, v in tree.items() if k not in groups}
        out["layers"] = [lp for g, (n, _) in zip(groups, self.layer_groups())
                         for lp in layer_views(tree[g], n)]
        return out

    def init_params(self, generator: torch.Generator, device) -> Dict[str, Any]:
        """Random parameters on ``device`` from ``generator``, split by layer."""
        return self.split_layers(init_params(
            self.param_specs(), generator, dtype=self.dtype, device=device))

    def init_train_params(self, generator: torch.Generator,
                          device) -> Dict[str, Any]:
        """Random float32 training parameters in the JAX layout (stacked
        groups ``g<i>``), each leaf requiring a gradient."""
        return trainable(init_params(self.param_specs(), generator,
                                     dtype=torch.float32, device=device))

    # ----------------------------------------------------------------- block
    def _ffn(self, i: int, lp, x, moe_group=None, tp=None):
        """Residual + the FFN of layer i (dense MLP or MoE), and the MoE
        aux loss (None for a dense layer).  The MoE block's capacity follows
        the call's token count, or the global batch's under a split
        ``moe_group`` (``models.moe.MoEGroup``, sharded training); ``tp``
        (``parallel.tensor.TensorParallel``): ``x`` is this rank's part of
        the residual stream and ``lp`` holds its ffn columns / experts."""
        cfg = self.cfg
        h = apply_norm(cfg, lp["ln2"], x)
        if self.dense_layers[i]:
            if tp is None:
                return x + mlp(cfg, lp["ffn"], h), None
            return x + tp.leave(mlp(cfg, lp["ffn"], tp.enter(h))), None
        out, aux = moe_forward(cfg, lp["ffn"], h, moe_group, tp)
        return x + out, aux

    def _attention(self, p, h, positions, tp=None):
        """Self-attention of one layer.  Under ``tp`` its heads split over
        ``model`` (the local heads read from wq and wk; wk and wv whole
        where the kv heads do not divide) and the output summed over it, or
        where the heads do not divide, run whole on every model rank."""
        cfg = self.cfg
        kw = dict(causal=True, window_eff=cfg.window)
        if tp is None:
            return attn.attention(cfg, p, h, positions, **kw)
        n_local = p["wq"].shape[1] // cfg.head_dim
        if n_local == cfg.n_heads:                   # heads whole
            return tp.leave_whole(attn.attention(
                cfg, p, tp.enter_whole(h), positions, **kw))
        kv_index = (attn.local_kv_heads(cfg, n_local, tp.rank)
                    if p["wk"].shape[1] == cfg.kv_dim else None)
        return tp.leave(attn.attention(cfg, p, tp.enter(h), positions,
                                       kv_index=kv_index, **kw))

    def _embed(self, params, tokens, tp=None):
        """The embedding of ``tokens``; under ``tp`` the vocab-parallel
        lookup, summed over ``model`` onto this rank's part of the residual
        stream."""
        if tp is None:
            return take_embedding(params["embed"], tokens).to(self.dtype)
        return tp.leave(take_embedding(params["embed"], tokens, tp)
                        .to(self.dtype))

    def _logits(self, params, x, tp=None):
        """The final norm and the lm_head; under ``tp`` the norm on this
        rank's part of the residual stream, then the whole sequence through
        this rank's block of the vocabulary (its logits alone)."""
        cfg = self.cfg
        x = apply_norm(cfg, params["final_norm"], x)
        if tp is not None:
            x = tp.enter(x)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = softcap(x @ head.to(x.dtype), cfg.logit_softcap)
        if self.vp != cfg.vocab_size:                 # mask padded vocab rows
            n = logits.shape[-1]
            first = 0 if tp is None else tp.rank * n
            pad = torch.arange(first, first + n, device=x.device) \
                >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _layer(self, i: int, lp, x, positions, gather=None, moe_group=None,
               tp=None):
        """Layer i of the forward pass: (x, the MoE aux loss or None).
        ``gather``: the layer's leaves are shards, gathered here (inside
        the activation checkpoint, so the recompute gathers them again),
        ``gather(lp, i)``."""
        if gather is not None:
            lp = gather(lp, i)
        h = apply_norm(self.cfg, lp["ln1"], x)
        return self._ffn(i, lp, x + self._attention(lp["attn"], h, positions,
                                                    tp), moe_group, tp)

    # --------------------------------------------------------------- forward
    def forward(self, params, batch, *, remat: bool = False, gather=None,
                moe_group=None, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits (B, S, V) and the summed MoE aux loss.
        ``remat``: each layer under one activation checkpoint.  ``gather``
        (sharded training): ``params`` holds shards, and each part is
        gathered around its use, the layers' inside their checkpoints;
        ``moe_group``: the ranks the MoE layers route over; ``tp``
        (``parallel.tensor.TensorParallel``): ``params`` hold this rank's
        part over ``model``, the residual stream runs on its part and the
        logits are its block of the vocabulary."""
        def whole(tree):
            return tree if gather is None else gather(tree)
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self._embed(whole({"embed": params["embed"]}), tokens, tp)
        aux = torch.zeros((), device=x.device)
        for i, lp in enumerate(params["layers"]):
            if remat:
                x, a = checkpoint(self._layer, i, lp, x, positions, gather,
                                  moe_group, tp, use_reentrant=False)
            else:
                x, a = self._layer(i, lp, x, positions, gather, moe_group, tp)
            if a is not None:
                aux = aux + a
        head = "embed" if self.cfg.tie_embeddings else "lm_head"
        return self._logits(whole({"final_norm": params["final_norm"],
                                   head: params[head]}), x, tp), aux

    def loss(self, params, batch, fsdp=None):
        """(loss + MoE aux, metrics) for params in the JAX layout (stacked
        groups), split into per-layer views here, each layer under an
        activation checkpoint; batch: tokens and labels (B, S).  CE with
        z-loss at ``z_loss_weight`` (1e-4 unless set on the model), as the
        JAX model's ``loss``.  ``fsdp`` (``repro_torch.parallel.fsdp.FSDP``):
        params are this rank's shards and batch its rows of the global
        batch; the parts are gathered around their use, the CE and z-loss
        sums divided by the global token count, the MoE layers route over
        ``fsdp.moe_group``, and over ``fsdp.tp`` the layers run tensor,
        sequence and expert parallel and the CE is vocab-parallel."""
        tp = None
        if fsdp is None:
            logits, aux = self.forward(self.split_layers(params), batch,
                                       remat=True)
        else:
            tp = fsdp.tp
            logits, aux = self.forward(fsdp.split(params), batch, remat=True,
                                       gather=fsdp.gather,
                                       moe_group=fsdp.moe_group, tp=tp)
        loss, metrics = cross_entropy_loss(
            logits, batch["labels"],
            z_loss_weight=getattr(self, "z_loss_weight", 1e-4),
            count=None if fsdp is None else fsdp.token_count, tp=tp)
        metrics["aux_loss"] = aux
        return loss + aux, metrics

    # ---------------------------------------------------------------- decode
    @property
    def ring(self) -> bool:
        """The cache is a sliding-window ring (the JAX package's ``_ring``):
        a windowed model whose cache is longer than its window."""
        return bool(self.cfg.window) and self.max_cache_len > self.cfg.window

    @property
    def cache_window(self) -> int:
        """Slots of the cache: the window for a ring, else its length."""
        return self.cfg.window if self.ring else self.max_cache_len

    def init_cache(self, batch: int, device,
                   dtype=torch.bfloat16) -> Dict[str, Any]:
        cfg = self.cfg
        shape = (batch, self.cache_window, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.n_layers)],
            "pos": 0,
        }

    def prefill(self, params, batch, cache=None):
        """Forward + cache population.  tokens: (B, S).  Returns the last
        position's logits (B, 1, V) and the cache."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        if cache is None:
            cache = self.init_cache(B, tokens.device)
        W = self.cache_window
        # slot s holds the latest position p == s (mod W), as in the JAX
        # package; with S < W the prompt fills the first S slots
        slots = (torch.tensor([S - 1 - ((S - 1 - s) % W) for s in range(W)],
                              device=tokens.device) if S >= W else None)
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self._embed(params, tokens)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(cfg, lp["ln1"], x)
            q = attn.project_q(cfg, lp["attn"], h, positions)
            k, v = attn.project_kv(cfg, lp["attn"], h, positions)
            a = attn.sdpa_auto(q, k, v, causal=True, window_eff=cfg.window)
            x = x + a.reshape(B, S, cfg.q_dim) @ lp["attn"]["wo"]
            for name, t in (("k", k), ("v", v)):
                c = cache[name][i]
                if slots is None:
                    c[:, :S] = t.to(c.dtype)
                else:
                    c.copy_(t[:, slots])
            x, _ = self._ffn(i, lp, x)
        cache["pos"] = S
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, tokens, cache):
        """tokens: (B, 1).  Returns (logits (B,1,V), cache), the cache
        updated in place.  A ring decodes past any length; a full-length
        cache raises past its end."""
        cfg = self.cfg
        pos = cache["pos"]
        if not self.ring and pos >= self.max_cache_len:
            raise ValueError(f"decode position {pos} is past the cache "
                             f"length {self.max_cache_len}")
        x = self._embed(params, tokens)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(cfg, lp["ln1"], x)
            a, _, _ = attn.decode_attention(cfg, lp["attn"], h, pos,
                                            cache["k"][i], cache["v"][i],
                                            ring=self.ring)
            x, _ = self._ffn(i, lp, x + a)
        cache["pos"] = pos + 1
        return self._logits(params, x), cache

