"""Mixture-of-experts family (olmoe-1b-7b, qwen2-moe-a2.7b).  Port of
``repro.models.moe``'s scatter path (``_moe_ffn_scatter``), the one the
reference takes with no mesh; its expert-parallel dispatch
(``moe_ffn_ep``) is a distributed path and is not ported here.

Dispatch is capacity-bounded ("dropping"): each token's top-k experts come
from a float32 softmax over a float32 router, a choice's slot in its
expert is its rank in the flattened (token, choice) order, choices past the
capacity are dropped, the kept tokens are scattered into an (E, C, D)
buffer, the experts run as batched matrix products (``torch.bmm``; the
reference's ``einsum``s are outside any Pallas kernel too), and each
token's k outputs are gathered back, weighted by their gates and added in
choice order.  Expert counts above 16 that are not a multiple of 16
(qwen2-moe: 60) are padded to the next multiple with the padded experts'
router logits set to -1e30.

The routing is integers that must equal the reference's bit for bit:
top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks them
(a stable sort); slots and drops come from a cumulative count.  The
combine adds a token's k contributions one after another in the compute
dtype, as the reference's scatter-add rounds after each add; no atomic
add, so the sum has one order on every device.

Attention goes through :mod:`repro_torch.models.layers` (the flash kernel
once per layer in prefill, the decode kernel once per layer per step).
:func:`backbone` and :func:`decode_step` loop over the layers in Python
where the reference scans; the functions expect params already cast to the
compute dtype (:mod:`repro_torch.models.lm` casts them).  The cache is the
dense family's: bf16 (L, B, T, K, HD) keys and values, written in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import pad_to
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.params import Spec, prefix, subtree


def padded_experts(cfg) -> int:
    return pad_to(cfg.num_experts, 16) if cfg.num_experts > 16 else cfg.num_experts


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: over the published expert
    count, not the padded one, as in the reference."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(pad_to(c, 8), 8)


def moe_specs(cfg, stack=()) -> dict[str, Spec]:
    st = tuple("layers" for _ in stack)
    D, Fd, Ep = cfg.d_model, cfg.moe_d_ff, padded_experts(cfg)
    sp = {
        "router": Spec(stack + (D, Ep), st + (None, None)),
        "wg": Spec(stack + (Ep, D, Fd), st + ("experts", "embed", "ff")),
        "wu": Spec(stack + (Ep, D, Fd), st + ("experts", "embed", "ff")),
        "wd": Spec(stack + (Ep, Fd, D), st + ("experts", "ff", "embed")),
    }
    if cfg.num_shared_experts:
        Fs = Fd * cfg.num_shared_experts
        sp["shared_wg"] = Spec(stack + (D, Fs), st + ("embed", "ff"))
        sp["shared_wu"] = Spec(stack + (D, Fs), st + ("embed", "ff"))
        sp["shared_wd"] = Spec(stack + (Fs, D), st + ("ff", "embed"))
        sp["shared_gate"] = Spec(stack + (D, 1), st + ("embed", None), "zeros")
    return sp


class Route(NamedTuple):
    """One layer's routing of T tokens: ``idx`` (T, k) experts and ``gates``
    (T, k) float32 weights, best first; ``slot`` and ``keep`` (T*k,) per
    flattened choice (a dropped choice has slot 0); ``probs`` (T, Ep) the
    float32 router softmax; ``capacity`` the slots per expert."""

    idx: torch.Tensor
    gates: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor
    capacity: int


def route(router, xf, cfg) -> Route:
    """Top-k routing of ``xf`` (T, D) through ``router`` (D, Ep), with slot
    ranks and drops at :func:`capacity` of T tokens."""
    T = xf.shape[0]
    E, Ep, k = cfg.num_experts, router.shape[1], cfg.top_k
    C = capacity(cfg, T)
    logits = xf.float() @ router.float()  # (T, Ep), float32 as the reference's
    experts = torch.arange(Ep, device=xf.device)
    if Ep > E:
        logits = logits.masked_fill(experts >= E, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: values in descending order, the lower index first on a tie
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)
    oh = (flat_e[:, None] == experts).to(torch.int32)  # one-hot without F.one_hot's check, a device sync
    slot = (torch.cumsum(oh, dim=0, dtype=torch.int32) * oh).sum(-1) - 1  # rank among the same expert's choices
    keep = slot < C
    return Route(idx, gates, torch.where(keep, slot, 0), keep, probs, C)


def aux_loss(r: Route, cfg):
    """The Switch load-balance loss, E * sum_e f_e * p_e / k, in float32."""
    Ep = r.probs.shape[1]
    f_e = (r.idx[..., None] == torch.arange(Ep, device=r.idx.device)).float().sum(1).mean(0)
    p_e = r.probs.mean(0)
    return cfg.num_experts * torch.sum(f_e * p_e) / cfg.top_k


def combine(yk):
    """(T, k, D) weighted expert outputs -> (T, D): each token's k added in
    choice order, rounded to their dtype after each add, as the reference's
    scatter-add ``zeros(T, D).at[tok_idx].add(yk)`` adds them."""
    y = yk[:, 0]
    for j in range(1, yk.shape[1]):
        y = y + yk[:, j]
    return y


def _experts(p, buf):
    """The SwiGLU experts on their (Ep, C, D) buffer."""
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    return torch.bmm(h, p["wd"])


def moe_ffn(p, x, cfg):
    """x: (B, S, D) -> (B, S, D), and the float32 aux load-balance loss."""
    Bb, S, D = x.shape
    T, k = Bb * S, cfg.top_k
    xf = x.reshape(T, D)
    r = route(p["router"], xf, cfg)
    Ep, C = r.probs.shape[1], r.capacity
    flat_e = r.idx.reshape(-1)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    # dispatch: every kept (expert, slot) is written once; dropped choices go
    # to a spare slot C, which is cut off
    buf = x.new_zeros((Ep, C + 1, D))
    buf[flat_e, torch.where(r.keep, r.slot, C)] = xf[tok_idx]
    out_buf = _experts(p, buf[:, :C])
    w = (r.gates.reshape(-1, 1) * r.keep[:, None]).to(x.dtype)
    y = combine((out_buf[flat_e, r.slot] * w).reshape(T, k, D))
    if cfg.num_shared_experts:
        sh = (F.silu(xf @ p["shared_wg"]) * (xf @ p["shared_wu"])) @ p["shared_wd"]
        y = y + torch.sigmoid(xf @ p["shared_gate"].to(x.dtype)) * sh
    return y.reshape(Bb, S, D), aux_loss(r, cfg)


def block_specs(cfg, n_layers) -> dict[str, Spec]:
    st = (n_layers,)
    sp = {}
    sp.update(prefix(L.attn_specs(cfg, stack=st), "attn"))
    sp.update(prefix(L.norm_specs(cfg, stack=st), "norm1"))
    sp.update(prefix(L.norm_specs(cfg, stack=st), "norm2"))
    sp.update(prefix(moe_specs(cfg, stack=st), "moe"))
    return sp


def param_specs(cfg, max_seq: int = 0) -> dict[str, Spec]:
    dense._check_supported(cfg)
    sp = {}
    sp.update(prefix(L.embed_specs(cfg), "embed"))
    sp.update(prefix(block_specs(cfg, cfg.num_layers), "blocks"))
    sp.update(prefix(L.norm_specs(cfg), "final_norm"))
    return sp


def block(lp, x, cfg, *, positions, causal=True):
    h, kv = L.self_attention(subtree(lp, "attn"), L.apply_norm(lp, "norm1", x, cfg), cfg, positions=positions,
                             causal=causal)
    x = x + h
    h, aux = moe_ffn(subtree(lp, "moe"), L.apply_norm(lp, "norm2", x, cfg), cfg)
    return x + h, kv, aux


def backbone(params, x, cfg, *, positions, causal=True, collect_kv=False):
    """Run the stacked blocks. x: (B, S, D) embeddings.  Returns the final
    normed activations, with ``collect_kv`` the stacked (L, B, S, K, HD)
    keys and values, and the aux loss averaged over the layers."""
    blocks = subtree(params, "blocks")
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, (k, v), a = block(dense._layer(blocks, i), x, cfg, positions=positions, causal=causal)
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(params, "final_norm", x, cfg)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None), aux / cfg.num_layers


def hidden(params, batch, cfg):
    tokens = batch["tokens"]
    x = L.embed(subtree(params, "embed"), tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    x, _, aux = backbone(params, x, cfg, positions=positions)
    return x, {"aux_loss": cfg.router_aux_weight * aux}


def forward(params, batch, cfg):
    x, aux = hidden(params, batch, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), aux


def prefill(params, batch, cfg):
    tokens = batch["tokens"]
    x = L.embed(subtree(params, "embed"), tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    x, kvs, _ = backbone(params, x, cfg, positions=positions, collect_kv=True)
    logits = L.unembed(subtree(params, "embed"), x[:, -1:], cfg)
    return logits, dense.build_cache(kvs, cfg)


def decode_step(params, batch, cache, cfg):
    """One token. batch: {token: (B,), pos: int}.  Writes the token's K/V
    into ``cache`` in place and returns (logits, cache)."""
    token, pos = batch["token"], int(batch["pos"])
    x = L.embed(subtree(params, "embed"), token[:, None], cfg)
    blocks = subtree(params, "blocks")
    for i in range(cfg.num_layers):
        lp = dense._layer(blocks, i)
        h, _ = L.decode_self_attention(subtree(lp, "attn"), L.apply_norm(lp, "norm1", x, cfg), cfg,
                                       cache_k=cache["k"][i], cache_v=cache["v"][i], pos=pos)
        x = x + h
        h, _ = moe_ffn(subtree(lp, "moe"), L.apply_norm(lp, "norm2", x, cfg), cfg)
        x = x + h
    x = L.apply_norm(params, "final_norm", x, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), cache


def cache_specs(cfg, batch: int, seq_len: int) -> dict[str, Spec]:
    return dense.cache_specs(cfg, batch, seq_len)
