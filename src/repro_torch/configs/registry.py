"""Architecture registry: full configs, reduced smoke variants, and the
per-(arch × shape) applicability matrix (skips documented in DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from ..models.config import ModelConfig

ARCH_IDS = [
    "llava-next-mistral-7b",
    "llama4-scout-17b-a16e",
    "olmoe-1b-7b",
    "qwen2.5-32b",
    "whisper-large-v3",
    "xlstm-1.3b",
    "qwen3-1.7b",
    "recurrentgemma-9b",
    "tinyllama-1.1b",
    "stablelm-12b",
]

# the port's own architectures, which the reference has not: resolved by
# ``get_config`` and ``get_smoke_config``, left out of ``ARCH_IDS`` and
# ``all_archs`` (the reference's pool)
PORT_ONLY_IDS = ["moonlight-16b-a3b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS + PORT_ONLY_IDS}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{ARCH_IDS + PORT_ONLY_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=512,
    <=4 experts — runs a forward/train step on CPU."""
    return _module(arch).SMOKE


def shape_supported(arch: str, shape: str) -> Optional[str]:
    """None if supported; else a human-readable skip reason."""
    cfg = get_config(arch)
    if shape == "long_500k":
        if arch == "whisper-large-v3":
            return ("enc-dec with full self+cross attention and a 448-token "
                    "decoder context by construction; 500k decode is "
                    "architecturally meaningless (DESIGN.md §4)")
    if shape in ("decode_32k", "long_500k") and cfg.family == "audio":
        return None  # whisper has a decoder; decode_32k runs
    return None


def serving_config(arch: str, shape: str) -> ModelConfig:
    """Shape-specific overrides (e.g. sliding-window serving mode for
    long_500k on pretrained-full-attention dense archs — a serving-mode
    override, not the arch's training attention; DESIGN.md §4)."""
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.family in ("dense", "moe", "vlm") \
            and cfg.attention == "full":
        cfg = cfg.with_overrides(attention="sliding", window=4096)
    return cfg


def all_archs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
