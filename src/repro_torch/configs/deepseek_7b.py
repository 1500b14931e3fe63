"""deepseek-7b [dense] — 30L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=102400; llama-arch.  [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab_size=102400,
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    max_seq_len=4096,
    source="[arXiv:2401.02954; hf]",
)
