"""Batched serving engine: prefill -> greedy decode with a dense KV cache and
an optional KV offload manager driven by attention mass.

Port of ``repro.serving.engine``.  The model runs on the engine's device
(the card unless the caller passes ``device="cpu"``).  The dense family
prefills through the flash-attention kernel and attends in every decode
step through the decode-attention kernel, once per layer; the ssm family
(Mamba-2) prefills through the SSD-scan kernel, once per layer, and
decodes its O(1) recurrence in plain PyTorch.  The offload manager's
residency is simulated, but its decision stream (hits / misses /
prefetches / thrash) is real and is what the serving benchmarks report.
As in the reference, only the families with a KV cache (dense, moe, vlm,
encdec) get an offload manager.

The KV cache (L, B, T, K, HD) is allocated at its final length once and
each decode step writes its token's K/V into it in place at ``pos`` (the
reference returns an updated copy, ``dynamic_update_slice``); the ssm
family's conv tails and SSM state are likewise updated in place.  The float32
master weights are cast to the compute dtype once, when the engine is
built, which computes the same numbers as the reference's cast per step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models import params as prm
from repro_torch.serving.kv_cache import PAGE_TOKENS
from repro_torch.serving.offload import KVOffloadManager, LearnedOffloadManager, LRUOffloadManager

#: offload manager per --offload kind: "lru" (baseline), "learned"
#: (attention-mass EMA driving the paper's policy engine), "manager" (the
#: full streaming OversubscriptionManager: classifier + per-pattern
#: predictor, fine-tuned on the KV touch stream + policy engine)
OFFLOAD_KINDS = {"lru": LRUOffloadManager, "learned": KVOffloadManager, "manager": LearnedOffloadManager}
#: the families with a KV cache, the only ones the reference offloads
KV_FAMILIES = ("dense", "moe", "vlm", "encdec")


def _tensor(x, device) -> torch.Tensor:
    """A tensor or array-like on ``device`` (numpy input is copied)."""
    return x.to(device) if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x), device=device)


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, n_new)
    steps: int
    offload_stats: dict | None


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, offload: str | None = None, hbm_fraction: float = 0.5,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = prm.cast_tree({k: _tensor(v, self.device) for k, v in params.items()},
                                    lm.compute_dtype(cfg))
        self.prefill = lm.make_prefill(cfg)
        self.decode = lm.make_decode_step(cfg)
        self.offload_kind = offload
        self.hbm_fraction = hbm_fraction

    def make_manager(self, total: int):
        """The offload manager for a KV cache of ``total`` tokens, or None
        (no offload kind, or a family without a KV cache)."""
        if not self.offload_kind or self.cfg.family not in KV_FAMILIES:
            return None
        n_pages = (total + PAGE_TOKENS - 1) // PAGE_TOKENS
        cap = max(int(n_pages * self.hbm_fraction), 1)
        mk = OFFLOAD_KINDS.get(self.offload_kind, LRUOffloadManager)
        return mk(n_pages, cap, device=self.device)

    def generate(self, batch: dict, n_new: int, pad_to: int | None = None) -> ServeResult:
        prompt = _tensor(batch["tokens"], self.device)
        B, S = prompt.shape
        total = S + n_new if pad_to is None else pad_to
        logits, cache = self.prefill(self.params, {**batch, "tokens": prompt})
        cache = self._grow_cache(cache, total)
        mgr = self.make_manager(total)

        out = np.zeros((B, n_new), np.int32)
        tok = torch.argmax(logits[:, -1], -1)
        pos = S
        for i in range(n_new):
            out[:, i] = tok.cpu().numpy()
            logits, cache = self.decode(self.params, {"token": tok, "pos": pos}, cache)
            if mgr is not None:
                self._drive_offload(mgr, cache, pos)
            tok = torch.argmax(logits[:, -1], -1)
            pos += 1
        return ServeResult(out, n_new, dataclasses.asdict(mgr.stats) if mgr else None)

    def _grow_cache(self, cache, total):
        """The self-attention caches padded with zeros to ``total`` tokens
        (arrays (L, B, S, ...) with S > 4, as in the reference)."""
        def grow(a):
            if a.dim() >= 3 and a.shape[2] < total and a.shape[2] > 4:
                out = a.new_zeros((*a.shape[:2], total, *a.shape[3:]))
                out[:, :, :a.shape[2]] = a
                return out
            return a

        return {k: (grow(v) if k in ("k", "v") else v) for k, v in cache.items()}

    @staticmethod
    def page_mass(cache, pos: int, n_pages: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-page attention mass and the touched pages after the step that
        wrote position ``pos``: the mean |K| over layers, batch, heads and
        head dims per token (one device reduction, one host copy), averaged
        per page; pages with at least half the largest mass count as
        touched."""
        k = cache["k"]
        valid = min(pos + 1, k.shape[2])
        mass_tok = torch.mean(k[:, :, :valid].abs(), dim=(0, 1, 3, 4), dtype=torch.float32).cpu().numpy()
        mass = np.zeros(n_pages)
        np_full = valid // PAGE_TOKENS
        if np_full:
            mass[:np_full] = mass_tok[: np_full * PAGE_TOKENS].reshape(np_full, PAGE_TOKENS).mean(1)
        rem = valid - np_full * PAGE_TOKENS
        if rem and np_full < n_pages:
            mass[np_full] = mass_tok[np_full * PAGE_TOKENS:].mean()
        # touched pages: pages carrying meaningful attention mass this step
        n_valid_pages = (valid + PAGE_TOKENS - 1) // PAGE_TOKENS
        live = mass[:n_valid_pages]
        thr = 0.5 * live.max() if live.size else 0.0
        touched = np.nonzero(mass >= thr)[0]
        if touched.size == 0:
            touched = np.arange(n_valid_pages)
        return mass, touched

    def _drive_offload(self, mgr, cache, pos):
        if "k" not in cache:
            return
        mgr.on_attention(*self.page_mass(cache, pos, mgr.n_pages))
