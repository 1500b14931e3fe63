"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064; QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=27648,
    vocab_size=152064,
    activation="silu",
    gated_mlp=True,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)
