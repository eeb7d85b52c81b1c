"""The paper's loss (Eqs. 2-3), port of ``repro.core.losses``:

    L = (1/|N|) sum_N [ L_CE + lambda * L_dis^G ] + (mu/|S|) sum_S L_thra

  * L_CE     — cross-entropy over delta classes (active classes only; the
               class space grows incrementally).
  * L_dis^G  — LUCIR's geodesic (cosine) feature-distillation term against
               the previous model's features.
  * L_thra   — Eq. 2: the additive inverse of CE restricted to the subset S
               of samples whose target page is already evicted (E) or
               thrashed (T).

:func:`ce`, :func:`lucir_distill`, :func:`thrash_term`, :func:`total_loss`
and :func:`top1_accuracy` are the reference functions in plain tensor ops.
The trainer calls :func:`train_loss`, which computes ``total_loss``'s value
with its CE and thrashing terms fused into the ``thrash_ce`` kernel: for a
batch of B samples with |S| = sum(in_et),

    mean(nll) + mu * (-sum(nll * s) / max(|S|, 1))
        == mean(nll * (1 - mu' * s)),   mu' = mu * B / max(|S|, 1),

and so is the gradient with respect to the logits.
"""
from __future__ import annotations

import torch

from repro_torch.core.predictor import mask_inactive
from repro_torch.kernels.thrash_ce import thrash_ce


def ce(logits, labels, n_active: int):
    """Per-sample negative log-likelihood over the first ``n_active`` classes."""
    lm = mask_inactive(logits, n_active)
    lse = torch.logsumexp(lm, -1)
    ll = torch.gather(lm, 1, labels.long()[:, None])[:, 0]
    return lse - ll


def lucir_distill(f_new, f_old):
    """1 - cos(f_new, sg(f_old)) per sample (LUCIR's L_dis^G)."""
    f_old = f_old.detach()
    nn_ = f_new / (torch.linalg.vector_norm(f_new, dim=-1, keepdim=True) + 1e-8)
    no = f_old / (torch.linalg.vector_norm(f_old, dim=-1, keepdim=True) + 1e-8)
    return 1.0 - torch.sum(nn_ * no, -1)


def thrash_term(logits, labels, in_et, n_active: int):
    """Eq. 2 over the S subset: sum y_i log p_i == -CE (mean over S)."""
    nll = ce(logits, labels, n_active)
    s = in_et.float()
    return -(nll * s).sum() / torch.clamp(s.sum(), min=1.0)


def total_loss(logits, f_new, labels, *, n_active: int, f_old=None, in_et=None, lam: float = 0.5,
               mu: float = 0.5):
    """Eq. 3.  ``f_old`` None: no distillation (first group); ``in_et`` None:
    no thrashing information.  Returns (loss, metrics)."""
    nll = ce(logits, labels, n_active)
    loss = nll.mean()
    metrics = {"ce": loss}
    if f_old is not None:
        dis = lucir_distill(f_new, f_old).mean()
        loss = loss + lam * dis
        metrics["lucir"] = dis
    if in_et is not None:
        th = thrash_term(logits, labels, in_et, n_active)
        loss = loss + mu * th
        metrics["thrash_term"] = th
    metrics["total"] = loss
    return loss, metrics


def top1_accuracy(logits, labels, n_active: int):
    return (mask_inactive(logits, n_active).argmax(-1) == labels).float().mean()


def train_loss(logits, f_new, labels, *, n_active: int, f_old=None, in_et=None, n_et: int = 0,
               lam: float = 0.5, mu: float = 0.5):
    """:func:`total_loss`'s value through the ``thrash_ce`` kernel.

    ``in_et``: the batch's E∪T flags on the logits' device, or None (no
    thrashing term: every weight 1).  ``n_et``: |S|, the number of set
    flags, counted by the caller from its host copy of the flags, so the
    loss needs no device sync.
    """
    mu_b = mu if in_et is None else mu * logits.shape[0] / max(n_et, 1)
    loss = thrash_ce(logits, labels, in_et, n_active, mu_b)
    if f_old is not None:
        loss = loss + lam * lucir_distill(f_new, f_old).mean()
    return loss
