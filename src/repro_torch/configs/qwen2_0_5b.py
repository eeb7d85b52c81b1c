"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

GQA, QKV bias. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

# Reduced config of the same family for CPU smoke tests.
SMOKE = CONFIG.replace(
    name="qwen2-0.5b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=503,
)
