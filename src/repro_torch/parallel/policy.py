"""Per-cell parallelisation policy: the port's own copy of
``repro.parallel.policy``.

``paper_defaults(cfg, shape)`` is the frozen paper-faithful schedule, field
for field as the JAX package's: the optimizer's memory modes by model (arctic:
no master, int8 moments; qwen3-32b, llava-next-34b, mixtral-8x7b: bf16
moments), full remat for every train cell, and attention chunks of 512 / 1024
from a sequence of 32768 on.  ``cell_policy`` returns it; with
``autostrategy=True`` the JAX package has the analytical FRED simulator
choose the strategy (``core/autostrategy.py``), which the port has not got
yet (ROADMAP.md M12), so that raises.
"""

from __future__ import annotations

from typing import Tuple

from ..models.config import ModelConfig, ParallelConfig, ShapeConfig
from ..train.optim import OptimConfig


def paper_defaults(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Tuple[ParallelConfig, OptimConfig]:
    """The frozen paper-faithful hierarchical schedule."""
    pcfg = ParallelConfig()
    ocfg = OptimConfig()

    # optimizer memory modes: arctic's 469e9 expert parameters cannot hold an
    # fp32 master and moments (12 bytes a parameter) in 256 x 16 GB; int8
    # moments and no master (6 bytes with the gradients) fit
    if cfg.name == "arctic-480b":
        ocfg = OptimConfig(master=False, moments_dtype="int8")
    elif cfg.name in ("qwen3-32b", "llava-next-34b", "mixtral-8x7b"):
        # 30-50e9 parameters: an fp32 master fits, bf16 moments halve the state
        ocfg = OptimConfig(master=True, moments_dtype="bfloat16")

    # full remat for every train cell
    if shape.kind == "train":
        pcfg = pcfg.replace(remat="full")

    # attention chunking for long sequences
    if shape.seq_len >= 32_768:
        pcfg = pcfg.replace(attn_q_chunk=512, attn_k_chunk=1024)

    return pcfg, ocfg


def cell_policy(cfg: ModelConfig, shape: ShapeConfig, mesh,
                autostrategy: bool = False) -> Tuple[ParallelConfig, OptimConfig]:
    """Policy for one (arch x shape x mesh) cell: ``paper_defaults``.  The
    simulator-chosen strategy (``autostrategy=True``) raises a
    ``ValueError``: the port has no decision stack yet."""
    if autostrategy:
        raise ValueError(
            "cell_policy(autostrategy=True) needs the FRED simulator's decision "
            "stack (core/autostrategy.py), which the port has not got yet: "
            "ROADMAP.md M12")
    return paper_defaults(cfg, shape)
