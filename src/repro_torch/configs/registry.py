"""Architecture registry of the port.

Mirrors ``repro.configs.registry``: lookup by id for ``--arch <id>``.  Every
architecture of the JAX package is ported; an unknown id raises a ``KeyError``.
The (arch x shape) applicability matrix is here too: ``cells()`` yields every
cell with whether it runs and, if not, why (``launch.dryrun`` records it).
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterator, Tuple

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

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


def shape_applicability(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention; 512k-token decode requires "
                       "sub-quadratic attention (SSM/hybrid/SWA only) — skip "
                       "per task spec, noted in DESIGN.md")
    return True, ""


def cells(archs=ARCH_IDS, shapes=SHAPES
          ) -> Iterator[Tuple[str, ModelConfig, ShapeConfig, bool, str]]:
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            ok, why = shape_applicability(cfg, s)
            yield a, cfg, s, ok, why
