"""mistral-7b-v0.1 — the paper's second workload (Table II).  32L d_model=4096
32H (GQA kv=8) d_ff=14336 vocab=32000; sliding-window 4096.
[hf:mistralai/Mistral-7B-v0.1; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    activation="silu",
    gated_mlp=True,
    attention="sliding",
    window=4096,
    rope_theta=10_000.0,
    max_seq_len=8192,
    source="[hf:mistralai/Mistral-7B-v0.1; hf] (paper Table II workload)",
)
