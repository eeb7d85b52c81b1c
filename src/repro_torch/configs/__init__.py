"""Port of ``repro.configs``: ``get_config(name)`` / ``get_smoke_config(name)``
for the architectures the port runs so far.  Any other name of the JAX
package's registry raises a ``KeyError`` that says it is not ported yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "predictor-paper": "repro_torch.configs.predictor_paper",
}

# The JAX package's other architectures (``repro.configs._MODULES``) and the
# ROADMAP item that ports each: the rest of the LM zoo, A6(c).
NOT_PORTED = dict.fromkeys(("whisper-medium", "olmoe-1b-7b", "qwen2-moe-a2.7b", "qwen3-0.6b", "internvl2-26b"), "A6(c)")


def _module(name: str):
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP {NOT_PORTED[name]}); ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
