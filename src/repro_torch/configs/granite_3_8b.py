"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(
    name="granite-3-8b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=517,
)
