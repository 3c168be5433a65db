"""Architecture registry of the port.

Mirrors ``repro.configs.registry``: lookup by id for ``--arch <id>``.  Every
architecture of the JAX package is ported; an unknown id raises a ``KeyError``.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

# every id the JAX package knows, in its order
ARCH_IDS = (
    "zamba2-2.7b",
    "llava-next-34b",
    "whisper-medium",
    "llama3.2-1b",
    "chatglm3-6b",
    "qwen3-32b",
    "qwen1.5-4b",
    "arctic-480b",
    "mixtral-8x7b",
    "mamba2-1.3b",
)

# every family: the dense decoder, the attention-free SSM stack, the hybrid,
# the mixture-of-experts, the VLM (patch prefix) and the audio encoder/decoder
PORTED_ARCH_IDS = ("llama3.2-1b", "chatglm3-6b", "qwen3-32b", "qwen1.5-4b",
                   "mamba2-1.3b", "zamba2-2.7b", "arctic-480b", "mixtral-8x7b",
                   "llava-next-34b", "whisper-medium")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in PORTED_ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
        return mod.CONFIG
    raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")


def all_configs() -> Dict[str, ModelConfig]:
    """Every configuration the port can run."""
    return {a: get_config(a) for a in PORTED_ARCH_IDS}
