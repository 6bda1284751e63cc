"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each module defines CONFIG (the published dims) and SMOKE (a reduced
same-family config for CPU tests), as data only, the same values as the
JAX package's `repro.configs`. The BCPNN scale presets are
`repro_torch.core.params.human_scale` / `rodent_scale`.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "xlstm-125m",
    "internlm2-1.8b",
    "stablelm-3b",
    "qwen2-1.5b",
    "gemma2-9b",
    "qwen3-moe-235b-a22b",
    "llama4-maverick-400b-a17b",
    "llama-3.2-vision-11b",
    "zamba2-7b",
    "whisper-large-v3",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE


def shrink(cfg, **over):
    return dataclasses.replace(cfg, **over)
