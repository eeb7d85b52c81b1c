"""Port of ``repro.configs``: ``get_config(name)`` / ``get_smoke_config(name)``
for the architectures the port runs so far.  Any other name of the JAX
package's registry raises a ``KeyError`` that says it is not ported yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "predictor-paper": "repro_torch.configs.predictor_paper",
}

# The JAX package's other architectures (``repro.configs._MODULES``); their
# families wait for the LM-zoo slice (ROADMAP A5).
NOT_PORTED = ("whisper-medium", "zamba2-7b", "mamba2-370m", "olmoe-1b-7b", "qwen2-moe-a2.7b",
              "qwen3-0.6b", "granite-3-8b", "qwen1.5-4b", "internvl2-26b")


def _module(name: str):
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP A5); ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
