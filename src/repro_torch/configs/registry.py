"""Architecture registry: the 10 assigned archs + the paper's subjects.

Each architecture lives in its own ``configs/<id>.py`` module (exact
assignment-table configuration, ``source`` records provenance); this
registry imports and indexes them.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_MODULES = [
    "command_r_35b", "phi4_mini_3_8b", "qwen3_4b", "qwen2_5_3b",
    "xlstm_1_3b", "recurrentgemma_2b", "llava_next_34b", "mixtral_8x22b",
    "granite_moe_1b_a400m", "seamless_m4t_medium",
    # the paper's own quantization subjects
    "llama_7b", "tiny_lm",
]

_REGISTRY: Dict[str, ArchConfig] = {}
for _m in _MODULES:
    _cfg = importlib.import_module(f"repro_torch.configs.{_m}").CONFIG
    _REGISTRY[_cfg.name] = _cfg

ASSIGNED: List[str] = [
    "command-r-35b", "phi4-mini-3.8b", "qwen3-4b", "qwen2.5-3b",
    "xlstm-1.3b", "recurrentgemma-2b", "llava-next-34b", "mixtral-8x22b",
    "granite-moe-1b-a400m", "seamless-m4t-medium",
]


def get(name: str) -> ArchConfig:
    key = name if name in _REGISTRY else name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> List[str]:
    return sorted(_REGISTRY)
