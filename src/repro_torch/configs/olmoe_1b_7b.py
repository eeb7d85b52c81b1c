"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304.

64 experts, top-8 routing, qk_norm. [arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,  # unused for routed layers; kept for completeness
    moe_d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    qk_norm=True,
    num_experts=64,
    top_k=8,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(
    name="olmoe-1b-7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    moe_d_ff=32,
    vocab_size=503,
    num_experts=8,
    top_k=2,
)
