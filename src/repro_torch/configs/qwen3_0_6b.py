"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

qk_norm, GQA, head_dim=128. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="qwen3-0.6b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=503,
)
