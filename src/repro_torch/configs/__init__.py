"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

One module per assigned architecture; each exposes ``CONFIG`` (exact config
from the assignment) and ``SMOKE`` (reduced same-family config for CPU
tests).  ``--arch <id>`` resolves through :func:`get_config`.

A copy of ``repro.configs`` (the same ``CONFIG`` and ``SMOKE`` for all ten
architectures); the port's models run all ten.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "xlstm_350m",
    "gemma3_1b",
    "internlm2_1_8b",
    "gemma_7b",
    "starcoder2_3b",
    "recurrentgemma_9b",
    "arctic_480b",
    "llama4_maverick_400b_a17b",
    "musicgen_medium",
    "internvl2_26b",
)

# accepted aliases (dashes as assigned)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({"llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b"})


def _resolve(arch: str) -> str:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return arch


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_resolve(arch)}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_resolve(arch)}").SMOKE
