"""The compile-once cache of the serving process (port of
``repro.uvm.server.aot``).

The reference exports the trainer's jitted scans with ``jax.export`` so
that a fresh process skips its tracing.  The port traces nothing: its one
compile-once artifact is the kernel library that
:mod:`repro_torch.kernels._lib` builds with ``nvcc``,
``librepro_torch_kernels_<digest>.so``, whose digest already covers the
CUDA sources and the compiler flags.  :func:`enable_aot` points the
process's :class:`~repro_torch.kernels._lib.KernelLibrary` at the cache
directory and loads the library from there before the first dispatch:

* a library for today's digest already in the directory is a **hit** (no
  ``nvcc``);
* one that ``nvcc`` builds into it in this process is a **miss**.

``fallbacks`` stays 0: the port has no fallback from a kernel to anything
else, and a failed build raises, as the library does everywhere.  It is
kept in :meth:`AotCache.stats` so that the ``# aot cache=...`` line of
``cli server`` keeps the reference's form.

Usage::

    trainer = Trainer(pcfg, tcfg, kind)          # on the card
    enable_aot(trainer, "~/.cache/repro-torch-aot")
"""
from __future__ import annotations

import os
from pathlib import Path

from repro_torch.kernels._lib import LIBRARY


class AotCache:
    """A directory of built kernel libraries, and what this process found
    there."""

    def __init__(self, root):
        self.root = Path(os.path.expanduser(str(root)))
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0  # libraries loaded from the directory (no nvcc)
        self.misses = 0  # libraries built into the directory by this process
        self.fallbacks = 0  # always 0: a failed build raises

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "fallbacks": self.fallbacks}


def enable_aot(trainer, cache) -> AotCache:
    """Build into and load from ``cache`` (an :class:`AotCache` or its
    directory) the kernel library ``trainer``'s dispatches launch, now,
    before the first dispatch.  Returns the cache, also set as
    ``trainer.aot_cache``.

    Raises ``ValueError`` for a trainer on the CPU (it launches no kernel)
    and ``RuntimeError`` when this process already loaded the library from
    another directory."""
    cache = cache if isinstance(cache, AotCache) else AotCache(cache)
    device = getattr(trainer, "device", None)
    if device is None or device.type != "cuda":
        raise ValueError(f"enable_aot caches the CUDA kernel library; the trainer runs on {device}, which "
                         f"launches no kernel")
    already = LIBRARY.loaded
    LIBRARY.use_build_dir(cache.root)
    LIBRARY.cdll()
    if already or LIBRARY.build_seconds is None:
        cache.hits += 1
    else:
        cache.misses += 1
    trainer.aot_cache = cache
    return cache
