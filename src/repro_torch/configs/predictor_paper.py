"""The paper's dual-block Transformer page predictor (Section IV-B).

``PredictorConfig`` keeps the JAX package's class name and field order, so
its ``repr`` (hashed into pretrain cache keys) is the same string.
:class:`BlockConfig` carries the fields of the JAX ``ModelConfig`` that the
predictor's Transformer blocks read.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class PredictorConfig:
    name: str = "predictor-paper"
    history: int = 10  # input sequence length (Section IV-D)
    d_model: int = 64
    num_heads: int = 2
    num_layers: int = 2  # Transformer layers per block (regular / irregular)
    d_ff: int = 128
    # feature vocabularies (hashed)
    page_vocab: int = 4096
    delta_vocab: int = 1024  # output classes: page deltas (grows incrementally)
    pc_vocab: int = 512
    tb_vocab: int = 512
    dropout: float = 0.0
    # LUCIR cosine classifier
    cosine_scale: float = 16.0
    # loss weights (Eq. 3)
    lucir_lambda: float = 0.5
    thrash_mu: float = 0.5
    num_patterns: int = 6  # DFA classes


@dataclass(frozen=True)
class BlockConfig:
    """One Transformer block stack: rms norm, swiglu MLP, rotary positions,
    no qkv bias, no qk-norm."""

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    head_dim: int
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    norm: str = "rms"
    act: str = "swiglu"
    pos: str = "rope"
    qkv_bias: bool = False
    qk_norm: bool = False


CONFIG = PredictorConfig()
SMOKE = PredictorConfig(name="predictor-paper-smoke", d_model=16, d_ff=32, num_heads=2, num_layers=1, page_vocab=64, delta_vocab=32, pc_vocab=16, tb_vocab=16)

# Quick-scale predictor: small enough for CPU minutes, with a delta
# vocabulary that does not alias the benchmarks' delta sets.
CONFIG_QUICK = PredictorConfig(
    name="predictor-quick", d_model=32, num_heads=2, num_layers=1, d_ff=64,
    page_vocab=2048, delta_vocab=512, pc_vocab=64, tb_vocab=64,
)
