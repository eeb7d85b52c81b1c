"""Mamba-2 (SSD, state-space duality): the attention-free LM family
(mamba2-370m).  Port of ``repro.models.mamba2``.

The sequence mixer is the chunked SSD of arXiv:2405.21060, computed by
:mod:`repro_torch.kernels.ssd_scan` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors), once per layer in prefill.  Decode is the
O(1) recurrent form carrying (conv tail, SSM state) per layer, in plain
PyTorch as in the reference.

Layers are stacked along a leading "layers" axis of every parameter, as in
the JAX package; :func:`hidden`, :func:`prefill` and :func:`decode_step`
loop over them in Python where the reference scans.  The functions expect
params already cast to the compute dtype (:mod:`repro_torch.models.lm`
casts them).  The cache holds the conv tails in the compute dtype and the
SSM state in float32, as the reference's ``prefill`` returns them;
:func:`decode_step` updates it in place (the reference returns new arrays).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as L
from repro_torch.models.params import Spec, prefix, subtree


def mixer_specs(cfg, stack=()) -> dict[str, Spec]:
    st = tuple("layers" for _ in stack)
    D, H, P, N, W = cfg.d_model, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    return {
        "wz": Spec(stack + (D, H, P), st + ("embed", "ssm_heads", None)),
        "wx": Spec(stack + (D, H, P), st + ("embed", "ssm_heads", None)),
        "wB": Spec(stack + (D, N), st + ("embed", None)),
        "wC": Spec(stack + (D, N), st + ("embed", None)),
        "wdt": Spec(stack + (D, H), st + ("embed", "ssm_heads")),
        "dt_bias": Spec(stack + (H,), st + ("ssm_heads",), "zeros"),
        "A_log": Spec(stack + (H,), st + ("ssm_heads",), "zeros"),
        "Dskip": Spec(stack + (H,), st + ("ssm_heads",), "ones"),
        # the depthwise conv runs separately on x, B and C
        "conv_wx": Spec(stack + (W, H, P), st + (None, "ssm_heads", None), "lecun"),
        "conv_bx": Spec(stack + (H, P), st + ("ssm_heads", None), "zeros"),
        "conv_wB": Spec(stack + (W, N), st + (None, None), "lecun"),
        "conv_bB": Spec(stack + (N,), st + (None,), "zeros"),
        "conv_wC": Spec(stack + (W, N), st + (None, None), "lecun"),
        "conv_bC": Spec(stack + (N,), st + (None,), "zeros"),
        # head-grouped gated RMSNorm: per-head statistics over P
        "gate_norm": Spec(stack + (H, P), st + ("ssm_heads", None), "ones"),
        "wo": Spec(stack + (H, P, D), st + ("ssm_heads", None, "embed")),
    }


def block_specs(cfg, n_layers) -> dict[str, Spec]:
    st = (n_layers,)
    sp = prefix(mixer_specs(cfg, stack=st), "mixer")
    sp.update(prefix(L.norm_specs(cfg, stack=st), "norm"))
    return sp


def _check_supported(cfg) -> None:
    if cfg.norm != "rms":
        raise NotImplementedError(f"{cfg.name}: norm={cfg.norm!r} is not ported yet (the port runs norm='rms')")


def param_specs(cfg, max_seq: int = 0) -> dict[str, Spec]:
    _check_supported(cfg)
    sp = {}
    sp.update(prefix(L.embed_specs(cfg), "embed"))
    sp.update(prefix(block_specs(cfg, cfg.num_layers), "blocks"))
    sp.update(prefix(L.norm_specs(cfg), "final_norm"))
    return sp


def causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, ...C); w: (W, ...C); b: (...C,)."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0) * (x.dim() - 2) + (W - 1, 0))
    out = sum(pad[:, i:i + S] * w[i] for i in range(W))
    return out + b


def conv_step(state, xnew, w, b):
    """state: (B, W-1, ...C) previous raw inputs; xnew: (B, ...C).  Returns
    (the conv output, the new tail)."""
    full = torch.cat([state, xnew[:, None]], dim=1)  # (B, W, ...C)
    y = sum(full[:, i] * w[i] for i in range(w.shape[0]))
    return y + b, full[:, 1:]


def silu(x):
    """``jax.nn.silu`` with the reference's rounding points: ``x *
    sigmoid(x)`` with the sigmoid as XLA lowers ``lax.logistic``, ``1 / (1
    + exp(-x))``, every step rounded to x's dtype (``F.silu`` rounds once,
    and in bf16 a third of its outputs then differ from the reference's by
    an ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x):
    """``jax.nn.softplus``, ``logaddexp(x, 0)``, with its rounding points:
    ``max(x, 0) + log1p(exp(-|x|))``, each step rounded to x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _project(p, xin, cfg):
    z = torch.einsum("bsd,dhp->bshp", xin, p["wz"])
    xs = torch.einsum("bsd,dhp->bshp", xin, p["wx"])
    b = xin @ p["wB"]
    c = xin @ p["wC"]
    dt_raw = torch.einsum("bsd,dh->bsh", xin, p["wdt"]) + p["dt_bias"]
    return z, xs, b, c, dt_raw


def cfg_dskip(p):
    return p["Dskip"][None, None, :, None]


def mixer(p, x, cfg, *, collect_state=False):
    """Full-sequence SSD mixer. x: (B, S, D).  With ``collect_state``, also
    the conv tails (the last W-1 raw inputs of x, B and C) and the final
    SSM state."""
    z, xs_raw, b_raw, c_raw, dt_raw = _project(p, x, cfg)
    xs = silu(causal_conv(xs_raw, p["conv_wx"], p["conv_bx"]))  # (B, S, H, P)
    b = silu(causal_conv(b_raw, p["conv_wB"], p["conv_bB"]))
    c = silu(causal_conv(c_raw, p["conv_wC"], p["conv_bC"]))
    dt = softplus(dt_raw)  # (B, S, H)
    y, final_state = ssd_scan(xs, dt, p["A_log"], b, c, chunk=cfg.ssm_chunk)
    y = y + cfg_dskip(p) * xs
    y = L.rms_norm(y * silu(z), p["gate_norm"], cfg.norm_eps)  # per-head statistics over P
    out = torch.einsum("bshp,hpd->bsd", y, p["wo"])
    if collect_state:
        W = cfg.conv_width
        tails = (xs_raw[:, -(W - 1):], b_raw[:, -(W - 1):], c_raw[:, -(W - 1):])
        return out, tails + (final_state,)
    return out, None


def mixer_decode(p, x, cfg, *, conv_x, conv_b, conv_c, ssm_state):
    """One-step recurrence. x: (B, 1, D); conv_x: (B, W-1, H, P); conv_b,
    conv_c: (B, W-1, N); ssm_state: (B, H, P, N) float32.  The tails and
    the state are updated in place; returns the mixer's output."""
    z, xs, b, c, dt_raw = _project(p, x, cfg)
    yx, tail_x = conv_step(conv_x, xs[:, 0], p["conv_wx"], p["conv_bx"])
    yb, tail_b = conv_step(conv_b, b[:, 0], p["conv_wB"], p["conv_bB"])
    yc, tail_c = conv_step(conv_c, c[:, 0], p["conv_wC"], p["conv_bC"])
    conv_x.copy_(tail_x)
    conv_b.copy_(tail_b)
    conv_c.copy_(tail_c)
    xs1, b1, c1 = silu(yx), silu(yb), silu(yc)  # (B, H, P), (B, N), (B, N)
    dt = softplus(dt_raw[:, 0]).float()  # (B, H)

    a = -torch.exp(p["A_log"].float())  # (H,)
    decay = torch.exp(dt * a)  # (B, H)
    update = torch.einsum("bh,bn,bhp->bhpn", dt, b1.float(), xs1.float())
    ssm_state.copy_(ssm_state * decay[:, :, None, None] + update)
    yh = torch.einsum("bn,bhpn->bhp", c1.float(), ssm_state).to(x.dtype)
    yh = yh + p["Dskip"][None, :, None] * xs1
    yh = L.rms_norm(yh[:, None] * silu(z), p["gate_norm"], cfg.norm_eps)  # (B, 1, H, P)
    return torch.einsum("bshp,hpd->bsd", yh, p["wo"])


def block(lp, x, cfg, *, collect_state=False):
    h, st = mixer(subtree(lp, "mixer"), L.apply_norm(lp, "norm", x, cfg), cfg, collect_state=collect_state)
    return x + h, st


def _layer(blocks, i: int):
    return {k: v[i] for k, v in blocks.items()}


def hidden(params, batch, cfg):
    _check_supported(cfg)
    x = L.embed(subtree(params, "embed"), batch["tokens"], cfg)
    blocks = subtree(params, "blocks")
    for i in range(cfg.num_layers):
        x, _ = block(_layer(blocks, i), x, cfg)
    return L.apply_norm(params, "final_norm", x, cfg), {}


def forward(params, batch, cfg):
    x, aux = hidden(params, batch, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), aux


def prefill(params, batch, cfg):
    """Returns the last position's logits and the cache: the stacked (L,
    ...) conv tails in the compute dtype and the SSM states in float32."""
    _check_supported(cfg)
    x = L.embed(subtree(params, "embed"), batch["tokens"], cfg)
    blocks = subtree(params, "blocks")
    states = []
    for i in range(cfg.num_layers):
        x, st = block(_layer(blocks, i), x, cfg, collect_state=True)
        states.append(st)
    x = L.apply_norm(params, "final_norm", x, cfg)
    logits = L.unembed(subtree(params, "embed"), x[:, -1:], cfg)
    cx, cb, cc, ssm = (torch.stack(s) for s in zip(*states))
    return logits, {"conv_x": cx, "conv_b": cb, "conv_c": cc, "ssm": ssm.float()}


def decode_step(params, batch, cache, cfg):
    """One token. batch: {token: (B,), pos: int (unused: the state carries
    the context)}.  Updates ``cache`` in place and returns (logits,
    cache)."""
    _check_supported(cfg)
    x = L.embed(subtree(params, "embed"), batch["token"][:, None], cfg)
    blocks = subtree(params, "blocks")
    for i in range(cfg.num_layers):
        lp = _layer(blocks, i)
        x = x + mixer_decode(subtree(lp, "mixer"), L.apply_norm(lp, "norm", x, cfg), cfg,
                             conv_x=cache["conv_x"][i], conv_b=cache["conv_b"][i], conv_c=cache["conv_c"][i],
                             ssm_state=cache["ssm"][i])
    x = L.apply_norm(params, "final_norm", x, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), cache


def cache_specs(cfg, batch: int, seq_len: int) -> dict[str, Spec]:
    # O(1) state: seq_len only documents the context the state summarises
    H, P, N, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    return {
        "conv_x": Spec((cfg.num_layers, batch, W - 1, H, P), ("layers", "batch", None, "ssm_heads", None), "zeros"),
        "conv_b": Spec((cfg.num_layers, batch, W - 1, N), ("layers", "batch", None, None), "zeros"),
        "conv_c": Spec((cfg.num_layers, batch, W - 1, N), ("layers", "batch", None, None), "zeros"),
        "ssm": Spec((cfg.num_layers, batch, H, P, N), ("layers", "batch", "ssm_heads", None, None), "zeros"),
    }
