"""Architecture registry of the port: ``get(arch_id)`` / ``get_smoke(arch_id)``.

Same published numbers as ``repro.configs``, for every architecture of
the reference: dense token-mode, Mamba2 (``ssm``), MoE, hybrid (hymba:
attention and SSM heads in every layer), the encoder (hubert-xlarge:
frame embeddings in, bidirectional) and the VLM backbone (internvl2-26b:
patch embeddings, then tokens).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

#: CLI ids of the ported architectures
PORTED = ("gemma-7b", "h2o-danube-1.8b", "deepseek-7b", "gemma3-1b",
          "mamba2-780m", "olmoe-1b-7b", "qwen2-moe-a2.7b", "hymba-1.5b",
          "hubert-xlarge", "internvl2-26b")

#: architectures of the reference whose layer kinds are not ported: none
#: since hubert-xlarge and internvl2-26b
NOT_PORTED: tuple[str, ...] = ()


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def _module(arch_id: str):
    name = _module_name(arch_id)
    if name not in map(_module_name, PORTED):
        raise KeyError(f"unknown architecture {arch_id!r}; known: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch_id: str, **overrides) -> ArchConfig:
    cfg = _module(arch_id).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke(arch_id: str, **overrides) -> ArchConfig:
    cfg = _module(arch_id).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def all_archs() -> list[str]:
    return list(PORTED)
