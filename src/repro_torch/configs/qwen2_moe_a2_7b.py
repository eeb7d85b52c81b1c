"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=151936.

4 shared + 60 routed experts, top-4 routing, QKV bias.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Sharding note: 60 routed experts do not divide the 16-way model axis; under
expert-parallel dispatch the routed experts are padded to 64 with router
masking (see DESIGN.md §4). `num_experts` stays at the published 60 — padding
is an implementation detail of the dispatcher.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    name="qwen2-moe-a2.7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    moe_d_ff=32,
    vocab_size=503,
    num_experts=6,
    num_shared_experts=2,
    top_k=2,
)
