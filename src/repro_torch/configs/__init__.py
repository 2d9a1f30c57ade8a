"""Config registry: one module per assigned architecture.

Usage::

    from repro_torch.configs import get_config, list_archs, SHAPES
    cfg = get_config("mixtral-8x7b")
    small = get_config("mixtral-8x7b", smoke=True)
"""
from __future__ import annotations

from .base import ArchConfig, MoEConfig, SSMConfig, ShapeSpec, SHAPES, input_specs, smoke

from . import (  # noqa: E402
    zamba2_2p7b,
    llava_next_mistral_7b,
    gemma3_27b,
    qwen2p5_32b,
    granite_20b,
    internlm2_1p8b,
    mixtral_8x7b,
    qwen3_moe_235b,
    mamba2_1p3b,
    musicgen_large,
)

_MODULES = [
    zamba2_2p7b,
    llava_next_mistral_7b,
    gemma3_27b,
    qwen2p5_32b,
    granite_20b,
    internlm2_1p8b,
    mixtral_8x7b,
    qwen3_moe_235b,
    mamba2_1p3b,
    musicgen_large,
]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    cfg = REGISTRY[name]
    if smoke:
        from .base import smoke as _smoke

        cfg = _smoke(cfg)
    return cfg


def cells(include_skipped: bool = True):
    """All 40 (arch, shape) cells; skipped cells flagged with reason."""
    out = []
    for name, cfg in sorted(REGISTRY.items()):
        for sname, sh in SHAPES.items():
            skip = ""
            if sname == "long_500k" and not cfg.supports_long_context:
                skip = "pure full-attention arch (see DESIGN.md §Arch-applicability)"
            if include_skipped or not skip:
                out.append((name, sname, skip))
    return out


__all__ = [
    "ArchConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeSpec",
    "SHAPES",
    "REGISTRY",
    "get_config",
    "list_archs",
    "input_specs",
    "smoke",
    "cells",
]
