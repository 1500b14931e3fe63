"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536; data-dependent decay.  [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,                      # 2560 / head_dim 64
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,                       # channel-mix hidden (3.5x)
    vocab_size=65536,
    attention="none",
    pos_embedding="none",
    rope_theta=0.0,
    max_seq_len=1_048_576,           # state-based: effectively unbounded
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, ffn_mult=3.5),
    source="[arXiv:2404.05892; hf]",
)
