"""Per-cell parallelisation policy: the port's own copy of
``repro.parallel.policy``.

Given (arch x shape x mesh) it returns the ``ParallelConfig`` /
``OptimConfig`` the step builders use, in one of two modes:

* ``autostrategy=False`` (default): ``paper_defaults``, the frozen
  paper-faithful schedule, field for field as the JAX package's: the
  optimizer's memory modes by model (arctic: no master, int8 moments;
  qwen3-32b, llava-next-34b, mixtral-8x7b: bf16 moments), full remat for
  every train cell, and attention chunks of 512 / 1024 from a sequence of
  32768 on.
* ``autostrategy=True``: the analytical FRED simulator
  (``repro_torch.core.autostrategy.choose``, whose sweep runs on ``device``,
  ``cuda`` unless given) picks the memory-feasible Pareto-optimal (mp, dp,
  pp, wafers, ep, sp) and, for cross-wafer DP, the inter-wafer topology,
  under the frozen defaults' optimizer and remat settings.  The decision is
  stamped on ``ParallelConfig.auto_strategy``, with
  ``grad_sync="hierarchical"`` for cross-wafer DP.  The mesh itself is built
  by the launcher; the stamped strategy is what the dry run records.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..models.config import (ModelConfig, ParallelConfig, ShapeConfig,
                             StrategyDecision)
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
                autostrategy: bool = False,
                sweep_kw: Optional[dict] = None,
                decision=None, *, device=None
                ) -> Tuple[ParallelConfig, OptimConfig]:
    """Policy for one (arch x shape x mesh) cell.

    ``autostrategy=True`` runs the simulator's sweep on ``device`` (``cuda``
    unless given; ``sweep_kw`` holds the
    :class:`~repro_torch.core.specs.DeploymentRequest` axes: n_npus,
    fabrics, max_wafers, npu_hbm_bytes, ...) and stamps the chosen strategy
    on the returned ``ParallelConfig``; with ``False`` the frozen defaults
    come back unchanged.  A precomputed
    :class:`~repro_torch.core.autostrategy.AutoStrategyDecision` passed as
    ``decision`` skips the sweep."""
    pcfg, ocfg = paper_defaults(cfg, shape)
    if not autostrategy:
        return pcfg, ocfg

    if decision is None:
        # lazy: core.autostrategy imports this module back
        from ..core.autostrategy import _build_request, choose
        decision = choose(_build_request(
            cfg, shape, master=ocfg.master, moments_dtype=ocfg.moments_dtype,
            remat=pcfg.remat, **(sweep_kw or {})), device=device)
    st = decision.strategy
    pcfg = pcfg.replace(auto_strategy=StrategyDecision(
        mp=st.mp, dp=st.dp, pp=st.pp, wafers=st.wafers,
        ep=st.ep, sp=st.sp,
        inter_topology=decision.inter_topology,
        defect_seed=getattr(decision, "defect_seed", None)))
    if st.wafers > 1:
        # cross-wafer DP reduces hierarchically: reduce-scatter within the
        # wafer, the chosen inter-wafer collective on the shard, all-gather
        # within the wafer
        pcfg = pcfg.replace(grad_sync="hierarchical")
    return pcfg, ocfg
