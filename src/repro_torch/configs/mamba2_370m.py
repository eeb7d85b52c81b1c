"""mamba2-370m [ssm] — 48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality). [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    conv_width=4,
    norm="rms",
)

SMOKE = CONFIG.replace(
    name="mamba2-370m-smoke",
    num_layers=2,
    d_model=64,
    ssm_state=16,
    ssm_headdim=16,
    vocab_size=503,
    ssm_chunk=16,
)
