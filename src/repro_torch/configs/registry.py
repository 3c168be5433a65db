"""Architecture registry of the port.

Mirrors ``repro.configs.registry``: lookup by id for ``--arch <id>``.  Only the
architectures whose model family the port can run are registered here; asking
for one of the others raises a ``KeyError`` that says it is not ported yet.
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

# the dense decoder family, the attention-free SSM stack, the hybrid and the
# mixture-of-experts family
PORTED_ARCH_IDS = ("llama3.2-1b", "chatglm3-6b", "qwen3-32b", "qwen1.5-4b",
                   "mamba2-1.3b", "zamba2-2.7b", "arctic-480b", "mixtral-8x7b")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in PORTED_ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
        return mod.CONFIG
    if arch in ARCH_IDS:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (its model "
            f"family is still to come, see ROADMAP.md); ported: "
            f"{list(PORTED_ARCH_IDS)}")
    raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")


def all_configs() -> Dict[str, ModelConfig]:
    """Every configuration the port can run."""
    return {a: get_config(a) for a in PORTED_ARCH_IDS}
