"""Learning-based baseline predictors for Fig. 10: LSTM, CNN, MLP (port of
``repro.core.baselines_nn``).

Same embeddings + cosine head as the paper's dual-Transformer predictor —
only the sequence encoder differs — so Fig. 10 isolates the encoder choice,
as the paper does.  Spec names, shapes and initialisers are the JAX
package's, so :func:`repro_torch.models.params.init_params_jax` draws its
weights; the encoders follow its arithmetic (LSTM gates i, f, g, o; the
causal convolution as ``k`` shifted matrix products summed in order).  No
TPU kernel lies in these encoders; their fine-tune steps run the
``thrash_ce`` kernel through the :class:`~repro_torch.core.incremental.Trainer`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.predictor_paper import PredictorConfig
from repro_torch.core import predictor as P
from repro_torch.models.params import Spec, init_params_jax, prefix
from repro_torch.uvm import registry as _registry


def _embed_head_specs(cfg: PredictorConfig) -> dict[str, Spec]:
    d = cfg.d_model
    return {
        "embed/page": Spec((cfg.page_vocab, d), (None, None), "normal", 0.02),
        "embed/delta": Spec((cfg.delta_vocab, d), (None, None), "normal", 0.02),
        "embed/pc": Spec((cfg.pc_vocab, d), (None, None), "normal", 0.02),
        "embed/tb": Spec((cfg.tb_vocab, d), (None, None), "normal", 0.02),
        "pos": Spec((cfg.history, d), (None, None), "normal", 0.01),
        "head/proj": Spec((2 * d, d), (None, None)),
        "head/classes": Spec((cfg.delta_vocab, d), (None, None), "normal", 0.02),
    }


def _combined_embed(params, batch):
    return (F.embedding(batch["page"], params["embed/page"]) + F.embedding(batch["delta"], params["embed/delta"])
            + F.embedding(batch["pc"], params["embed/pc"]) + F.embedding(batch["tb"], params["embed/tb"])
            + params["pos"][None])  # (B, T, d)


# --- LSTM -------------------------------------------------------------------

def lstm_specs(cfg) -> dict[str, Spec]:
    d = cfg.d_model
    sp = _embed_head_specs(cfg)
    sp.update(prefix({
        "wx": Spec((d, 4 * d), (None, None)),
        "wh": Spec((d, 4 * d), (None, None)),
        "b": Spec((4 * d,), (None,), "zeros"),
        "proj": Spec((d, 2 * d), (None, None)),
    }, "enc"))
    return sp


def lstm_features(params, batch, cfg):
    x = _combined_embed(params, batch)
    B, T, d = x.shape
    h = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    for t in range(T):
        z = x[:, t] @ params["enc/wx"] + h @ params["enc/wh"] + params["enc/b"]
        i, f, g, o = torch.split(z, d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return ((h @ params["enc/proj"]) @ params["head/proj"]).float()


# --- CNN --------------------------------------------------------------------

def cnn_specs(cfg) -> dict[str, Spec]:
    d = cfg.d_model
    sp = _embed_head_specs(cfg)
    sp.update(prefix({
        "w1": Spec((3, d, d), (None, None, None)),
        "b1": Spec((d,), (None,), "zeros"),
        "w2": Spec((3, d, d), (None, None, None)),
        "b2": Spec((d,), (None,), "zeros"),
        "proj": Spec((d, 2 * d), (None, None)),
    }, "enc"))
    return sp


def _conv1d(x, w, b):
    """x: (B,T,d) causal convolution with kernel (k, d_in, d_out): the k
    shifted products summed in order, as the JAX package computes it."""
    k, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:T] @ w[0]
    for i in range(1, k):
        out = out + pad[:, i : i + T] @ w[i]
    return out + b


def cnn_features(params, batch, cfg):
    x = _combined_embed(params, batch)
    h = torch.relu(_conv1d(x, params["enc/w1"], params["enc/b1"]))
    h = torch.relu(_conv1d(h, params["enc/w2"], params["enc/b2"]))
    return ((h.mean(1) @ params["enc/proj"]) @ params["head/proj"]).float()


# --- MLP --------------------------------------------------------------------

def mlp_specs(cfg) -> dict[str, Spec]:
    d = cfg.d_model
    sp = _embed_head_specs(cfg)
    sp.update(prefix({
        "w1": Spec((cfg.history * d, 2 * d), (None, None)),
        "b1": Spec((2 * d,), (None,), "zeros"),
        "w2": Spec((2 * d, 2 * d), (None, None)),
        "b2": Spec((2 * d,), (None,), "zeros"),
    }, "enc"))
    return sp


def mlp_features(params, batch, cfg):
    x = _combined_embed(params, batch)
    h = x.reshape(x.shape[0], -1)
    h = torch.relu(h @ params["enc/w1"] + params["enc/b1"])
    h = torch.relu(h @ params["enc/w2"] + params["enc/b2"])
    return (h @ params["head/proj"]).float()


# --- unified factory ---------------------------------------------------------

def _builder_from_specs(specs, feat):
    """Wrap a (specs(cfg), features(params, batch, cfg)) pair — the shape all
    cosine-head encoders share — into the registry builder contract."""

    def build(cfg: PredictorConfig):
        def fwd(params, batch):
            f = feat(params, batch, cfg)
            return P.cosine_logits(params, f, cfg), f

        return (lambda seed, device: init_params_jax(seed, specs(cfg), torch.float32, device)), fwd

    return build


def make_model(cfg: PredictorConfig, kind: str):
    """Returns ``(init_fn(seed, device) -> params, forward_fn(params, batch)
    -> (logits, feats))``; ``kind`` is looked up in the predictor registry."""
    return _registry.predictor_builder(kind)(cfg)


if "transformer" not in _registry.predictor_names():  # idempotent under reload
    _registry.register_predictor(
        "transformer", lambda cfg: ((lambda seed, device: P.init(seed, cfg, device)),
                                    (lambda p, b: P.forward(p, b, cfg))))
    _registry.register_predictor("lstm", _builder_from_specs(lstm_specs, lstm_features))
    _registry.register_predictor("cnn", _builder_from_specs(cnn_specs, cnn_features))
    _registry.register_predictor("mlp", _builder_from_specs(mlp_specs, mlp_features))
