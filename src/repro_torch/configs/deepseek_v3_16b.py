"""deepseek-v3-16b — the paper's MoE workload (§VII-C, trained with Primus/
torchtitan, 8-way expert parallel).  DeepSeek-MoE-16B dims with V3-style
sigmoid routing.  [arXiv:2412.19437 + 2401.06066]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=102400,
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    max_seq_len=4096,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  router="sigmoid", first_k_dense=1, d_ff_dense=10944),
    source="[arXiv:2412.19437; paper §VII-C MoE workload]",
)
