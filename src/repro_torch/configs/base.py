"""Model + input-shape configuration (a copy of ``repro.configs.base``: it
is data).  ``param_count`` goes through the port's :mod:`repro_torch.models.lm`."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm: str = "rms"  # rms | ln
    act: str = "swiglu"  # swiglu | gelu
    pos: str = "rope"  # rope | learned | none
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): shared attention block applied every `attn_every` SSM layers
    attn_every: int = 0

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_len: int = 1500  # whisper 30s window -> 1500 frames
    enc_feat: int = 128  # stub frontend feature dim (precomputed frame embeddings)

    # vlm (internvl2)
    num_patches: int = 0
    patch_feat: int = 0  # stub frontend patch-embedding dim

    # numerics / padding
    dtype: str = "bfloat16"
    vocab_pad: int = 256
    kv_quant: str = "none"  # none | int8 — per-token-head symmetric KV quantisation

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad)

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Analytic parameter / FLOP accounting (used by the roofline report).
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        from repro_torch.models import lm

        return lm.param_count(self)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
