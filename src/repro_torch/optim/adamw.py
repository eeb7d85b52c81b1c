"""AdamW with global-norm clipping and schedules, functional over dicts of
tensors (port of ``repro.optim.adamw``; not ``torch.optim.AdamW``).

``OptState`` mirrors the parameter dict with float32 first and second
moments, like the JAX package's, so a pretrain memo's optimizer state maps
onto it field for field.  The update keeps the reference's order of
operations: clip by the global norm first; ``stepf = step + 1`` and the
bias corrections ``1 - b**stepf`` in float32; the decoupled weight decay
inside the update ``u``; ``p + u`` in float32, cast back to ``p``'s dtype.
Step counts and schedules are host numbers (float32 numpy scalars), so an
update needs no device sync.  The elementwise steps run as
``torch._foreach_*`` operations over all the leaves at once (the same
operation per element as one tensor at a time, in far fewer launches: the
predictor has 29 leaves).  Everything runs under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class OptState(NamedTuple):
    m: dict
    v: dict


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state, grad norm)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = np.float32(step)
        if step < warmup:
            return np.float32(peak_lr) * step / np.float32(max(warmup, 1))
        prog = np.clip((step - np.float32(warmup)) / np.float32(max(total - warmup, 1)), np.float32(0),
                       np.float32(1))
        cos = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * prog))
        return np.float32(peak_lr) * (np.float32(floor) + np.float32(1 - floor) * cos)

    return lr


def constant_schedule(lr_val: float):
    return lambda step: np.float32(lr_val)


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm over every leaf, summed in the reference's leaf order
    (sorted keys)."""
    leaves = [tree[k].float() for k in sorted(tree)]
    return torch.sqrt(sum(torch.sum(sq) for sq in torch._foreach_mul(leaves, leaves)))


@torch.no_grad()
def clip_by_global_norm(tree: dict, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return dict(zip(tree, torch._foreach_mul([g.float() for g in tree.values()], scale))), norm


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def init(params: dict) -> OptState:
        """Zero moments shaped like ``params`` (on the params' devices)."""
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
        return OptState(m=zeros, v={k: z.clone() for k, z in zeros.items()})

    @torch.no_grad()
    def update(grads: dict, state: OptState, params: dict, step: int):
        keys = list(grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        g = [grads[k] for k in keys]
        stepf = np.float32(step) + np.float32(1.0)
        m = torch._foreach_add(torch._foreach_mul([state.m[k] for k in keys], b1), torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_add(torch._foreach_mul([state.v[k] for k in keys], b2),
                               torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        bc1 = float(np.float32(1) - np.float32(b1) ** stepf)
        bc2 = float(np.float32(1) - np.float32(b2) ** stepf)
        neg_lr = float(-np.float32(lr_fn(step)))
        # u = -lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), eps)
        u = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        u = torch._foreach_add(u, torch._foreach_mul([params[k].float() for k in keys], weight_decay))
        u = torch._foreach_mul(u, neg_lr)
        updates = {k: x.to(params[k].dtype) for k, x in zip(keys, u)}
        return updates, OptState(m=dict(zip(keys, m)), v=dict(zip(keys, v))), gnorm

    return Optimizer(init=init, update=update)


def init(params: dict) -> OptState:
    """Zero moments shaped like ``params`` (on the params' devices)."""
    return adamw(0.0).init(params)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    keys = list(params)
    summed = torch._foreach_add([params[k].float() for k in keys], [updates[k].float() for k in keys])
    return {k: x.to(params[k].dtype) for k, x in zip(keys, summed)}
