"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400, MoE 2 shared + 64 routed top-6, fine-grained, first layer dense.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,                       # per (fine-grained) expert
    vocab_size=102400,
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    max_seq_len=4096,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  first_k_dense=1, d_ff_dense=10944),
    source="[arXiv:2401.06066; hf]",
)
