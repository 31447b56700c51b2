"""Architecture registry of the port: all ten architectures of
``repro.configs``. Slice 1 ported gemma-2b, slice 7 mamba2-780m, slice 8
the rest of the dense family (gemma-7b, granite-3-8b, qwen2.5-14b), slice
9 the hybrid zamba2-2.7b, slice 10 the moe granite-moe-3b-a800m, slice 11
mixtral-8x7b (moe with a sliding window), slice 12 the vlm
llama-3.2-vision-11b and the audio musicgen-medium."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer import ModelConfig

ARCH_IDS = ("gemma-2b", "gemma-7b", "granite-3-8b", "qwen2.5-14b", "mamba2-780m",
            "zamba2-2.7b", "granite-moe-3b-a800m", "mixtral-8x7b",
            "llama-3.2-vision-11b", "musicgen-medium")

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCH_IDS}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).REDUCED
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
