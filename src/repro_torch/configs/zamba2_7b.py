"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.

Mamba2 backbone + shared attention block applied every 6 SSM layers
(weights shared across applications; each application keeps its own KV cache).
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    conv_width=4,
    attn_every=6,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.replace(
    name="zamba2-7b-smoke",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=503,
    ssm_state=16,
    ssm_headdim=16,
    attn_every=2,
    ssm_chunk=16,
)
