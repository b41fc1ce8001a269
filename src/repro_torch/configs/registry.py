"""Architecture registry: --arch <id> lookup for the assigned pool.

The same ten configurations as the JAX package's `repro.configs`, one data
file each; `repro_torch.models.lm.build_lm` builds every one of them."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.lm.config import ArchConfig

ARCH_IDS: List[str] = [
    "qwen3-32b",
    "qwen1.5-0.5b",
    "whisper-large-v3",
    "mixtral-8x7b",
    "arctic-480b",
    "qwen2.5-14b",
    "zamba2-2.7b",
    "mamba2-2.7b",
    "deepseek-7b",
    "llava-next-mistral-7b",
]

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "whisper-large-v3": "whisper_large_v3",
    "mixtral-8x7b": "mixtral_8x7b",
    "arctic-480b": "arctic_480b",
    "qwen2.5-14b": "qwen2_5_14b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "deepseek-7b": "deepseek_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCH_IDS)
