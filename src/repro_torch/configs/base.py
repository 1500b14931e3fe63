"""Model config dataclasses for the PyTorch port.

A copy of the model half of ``repro.configs.base`` (``ModelConfig``, its
family sub-configs and ``reduce_config``): the port must not import the JAX
package, whose ``repro`` import chain pulls in JAX, and the machine with the
card has no JAX.  ``TrainConfig`` is a copy too, for the training slice;
shapes and parallelism configs wait for the slices that use them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


# --------------------------------------------------------------------------- #
# Sub-configs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (routed + optional shared experts)."""

    n_experts: int
    top_k: int
    d_expert: int                      # per-expert hidden dim
    n_shared: int = 0                  # always-on shared experts
    router: str = "softmax"            # "softmax" | "sigmoid" (deepseek-v3)
    capacity_factor: float = 1.25      # padded dispatch capacity (paper: padded GEMMs)
    aux_loss_weight: float = 0.01      # load-balancing auxiliary loss
    first_k_dense: int = 0             # leading layers that use a dense MLP
    d_ff_dense: int = 0                # dense-MLP hidden dim for those layers


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM config (hymba's parallel SSM heads)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix / channel-mix config."""

    head_dim: int = 64
    decay_lora: int = 64               # low-rank dim for data-dependent decay
    mix_lora: int = 32                 # low-rank dim for the 5-way token-shift mix
    ffn_mult: float = 3.5              # channel-mix hidden = ffn_mult * d_model


@dataclass(frozen=True)
class VisionConfig:
    """Stub modality frontend: inputs are precomputed patch embeddings."""

    vision_dim: int = 1280             # dim of precomputed patch embeddings
    vision_seq: int = 1601             # patches per image (stubbed frontend)
    cross_attn_every: int = 5          # every k-th layer is a cross-attn layer


@dataclass(frozen=True)
class AudioConfig:
    """Stub audio frontend: inputs are precomputed mel-frame embeddings."""

    frame_dim: int = 80                # mel bins of precomputed frames
    frame_seq: int = 1500              # encoder positions (whisper: 30 s / 20 ms)


# --------------------------------------------------------------------------- #
# Model config
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | encdec | hybrid | vlm | rwkv
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    # --- block options ------------------------------------------------------
    activation: str = "silu"           # silu | squared_relu | gelu
    gated_mlp: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"        # rope | learned | none
    tie_embeddings: bool = False
    attention: str = "full"            # full | sliding | none
    window: int = 0                    # sliding-window size
    global_attn_layers: tuple = ()     # layers forced to full attention (hymba)
    logit_softcap: float = 0.0         # grok-style tanh soft-capping (0 = off)
    max_seq_len: int = 131_072
    # --- family extensions ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    enc_layers: int = 0                # encoder depth for enc-dec (whisper)
    # --- numerics ------------------------------------------------------------
    param_dtype: str = "float32"       # master/param dtype for training
    compute_dtype: str = "bfloat16"    # activation/matmul dtype
    serve_dtype: str = "bfloat16"      # weight dtype for inference
    # --- provenance ----------------------------------------------------------
    source: str = ""                   # [source; verified-tier] from assignment

    # ------------------------------------------------------------------ utils
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Whether long-context decode (long_500k) is feasible."""
        if self.family in ("rwkv",):
            return True
        if self.family == "hybrid":
            return self.attention == "sliding"
        return self.attention == "sliding"

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode path (whisper is enc-dec)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------- param accounting
    def _mlp_params(self, d_ff: int) -> int:
        mats = 3 if self.gated_mlp else 2
        return mats * self.d_model * d_ff

    def _attn_params(self) -> int:
        p = self.d_model * self.q_dim            # Wq
        p += 2 * self.d_model * self.kv_dim      # Wk, Wv
        p += self.q_dim * self.d_model           # Wo
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        return p

    def _ssm_params(self) -> int:
        if self.ssm is None:
            return 0
        c = self.ssm
        d_inner = c.expand * self.d_model
        dt_rank = c.dt_rank or -(-self.d_model // 16)
        p = self.d_model * 2 * d_inner           # in_proj (x, z)
        p += d_inner * c.d_conv                  # depthwise conv
        p += d_inner * (dt_rank + 2 * c.d_state) # x -> (dt, B, C)
        p += dt_rank * d_inner                   # dt proj
        p += d_inner * c.d_state                 # A_log
        p += d_inner                             # D
        p += d_inner * self.d_model              # out proj
        return p

    def _rwkv_layer_params(self) -> int:
        c = self.rwkv
        d = self.d_model
        # time-mix: r,k,v,g,o projections + low-rank decay + low-rank mix + ln_x
        p = 5 * d * d
        p += 2 * d * c.decay_lora
        p += 5 * 2 * d * c.mix_lora              # 5-way token-shift mix LoRA
        p += 2 * d                               # per-head group-norm (ln_x)
        p += 2 * (d // c.head_dim) * c.head_dim  # time_first/time_decay bases
        # channel-mix: k (d->h), v (h->d), r (d->d)
        h = int(c.ffn_mult * d)
        p += d * h + h * d + d * d
        return p

    def layer_params(self, layer_idx: int) -> int:
        """Parameter count of one decoder layer (norms excluded: negligible)."""
        if self.family == "rwkv":
            return self._rwkv_layer_params()
        p = self._attn_params()
        if self.family == "hybrid":
            p += self._ssm_params()
        if self.family == "vlm" and self.vision is not None:
            k = self.vision.cross_attn_every
            if (layer_idx + 1) % k == 0:
                p += self._attn_params()         # extra cross-attn projections
        if self.moe is not None:
            if layer_idx < self.moe.first_k_dense:
                p += self._mlp_params(self.moe.d_ff_dense or self.d_ff)
            else:
                n = self.moe.n_experts + self.moe.n_shared
                p += n * self._mlp_params(self.moe.d_expert)
                p += self.d_model * self.moe.n_experts   # router
        else:
            p += self._mlp_params(self.d_ff)
        return p

    def active_layer_params(self, layer_idx: int) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if self.moe is None or layer_idx < (self.moe.first_k_dense or 0):
            return self.layer_params(layer_idx)
        p = self._attn_params()
        if self.family == "hybrid":
            p += self._ssm_params()
        k = self.moe.top_k + self.moe.n_shared
        p += k * self._mlp_params(self.moe.d_expert)
        p += self.d_model * self.moe.n_experts
        return p

    def param_count(self) -> int:
        p = sum(self.layer_params(i) for i in range(self.n_layers))
        emb = self.vocab_size * self.d_model
        p += emb if self.tie_embeddings else 2 * emb
        if self.pos_embedding == "learned":
            p += self.max_seq_len * self.d_model
        if self.enc_layers:                      # whisper encoder (dense MHA+MLP)
            enc = self.enc_layers * (4 * self.d_model * self.d_model
                                     + 2 * self.d_model * self.d_ff)
            dec_cross = self.n_layers * self._attn_params()  # decoder cross-attn
            p += enc + dec_cross
        if self.vision is not None:
            p += self.vision.vision_dim * self.d_model      # connector proj
        if self.audio is not None:
            p += self.audio.frame_dim * self.d_model        # conv-stub proj
        return p

    def active_param_count(self) -> int:
        p = sum(self.active_layer_params(i) for i in range(self.n_layers))
        emb = self.vocab_size * self.d_model
        p += emb if self.tie_embeddings else 2 * emb
        if self.enc_layers:
            p += self.enc_layers * (4 * self.d_model * self.d_model
                                    + 2 * self.d_model * self.d_ff)
            p += self.n_layers * self._attn_params()
        return p


# --------------------------------------------------------------------------- #
# Run configs
# --------------------------------------------------------------------------- #
@dataclass
class TrainConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss_weight: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3


# --------------------------------------------------------------------------- #
# Reduced (smoke) configs
# --------------------------------------------------------------------------- #
def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to laptop scale, preserving family features.

    Used by per-arch smoke tests: same block structure (MoE routing, ssm,
    cross-attn interleave, enc-dec, qk-norm, ...) at tiny dims.
    """
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        max_seq_len=256,
        window=min(cfg.window, 32) if cfg.window else 0,
    )
    if cfg.global_attn_layers:
        kw["global_attn_layers"] = (0, kw["n_layers"] - 1)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1),
            d_expert=32,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            d_ff_dense=128 if cfg.moe.first_k_dense else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=8)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=16, decay_lora=8,
                                         mix_lora=8)
    if cfg.vision is not None:
        kw["vision"] = dataclasses.replace(cfg.vision, vision_dim=32,
                                           vision_seq=16, cross_attn_every=2)
        kw["n_layers"] = 4
    if cfg.audio is not None:
        kw["audio"] = dataclasses.replace(cfg.audio, frame_dim=16, frame_seq=32)
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    return cfg.replace(name=cfg.name + "-reduced", **kw)
