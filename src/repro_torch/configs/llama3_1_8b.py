"""llama-3.1-8b — the paper's default workload (Table II).  32L d_model=4096
32H (GQA kv=8) d_ff=14336 vocab=128256.  [hf:meta-llama/Llama-3.1-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    activation="silu",
    gated_mlp=True,
    rope_theta=500_000.0,
    max_seq_len=8192,
    source="[hf:meta-llama/Llama-3.1-8B; hf] (paper Table II workload)",
)
