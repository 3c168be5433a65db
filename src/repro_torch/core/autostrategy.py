"""Sweep-driven auto-strategy: the simulator picks (mp, dp, pp, wafers).

The paper's thesis (Sec. I, Fig. 2) is that a flexible fabric lets the
*compiler* pick whatever parallelization strategy compute/memory prefers.
This module closes that loop: given a registry ``ModelConfig`` and a
``ShapeConfig`` cell, it

  1. derives the analytical :class:`~repro_torch.core.workloads.Workload`
     via :func:`~repro_torch.core.workloads.from_model_config`,
  2. runs the (fabric × wafer shape × wafer count × inter-wafer topology
     × strategy) sweep of :mod:`repro_torch.core.sweep` with the per-NPU
     memory-feasibility model (weights + optimizer state per the
     OptimConfig master/moments dtypes + activation footprint under the
     remat setting, against an ``npu_hbm_bytes`` budget) and
     canonical-form symmetry pruning — the inter-wafer topology (ring /
     fully_connected / switch, core/cluster.py) is searched alongside
     the strategy, so the fabric flexes to the parallelization *and*
     vice versa,
  3. falls back to weight-streaming execution (Sec. III-A: weights stream
     through I/O, optimizer runs near storage) when no weight-stationary
     strategy fits — the paper's own answer for Transformer-1T-class
     models, and
  4. returns the Pareto-optimal feasible point as an
     :class:`AutoStrategyDecision`, with the dominated/infeasible counts
     that explain *why* (recorded by the dry-run and the decision table).

``repro_torch.parallel.policy.cell_policy(..., autostrategy=True)`` and
``repro_torch.launch.dryrun.run_cell(..., autostrategy=True)`` consume
this; :func:`decision_table` is the per-model table that
``tests/goldens/autostrategy.json`` pins.

The PyTorch port's own copy of ``repro.core.autostrategy``: the same code
(the port imports nothing of the JAX package); ``tests/test_torch_decide.py``
holds its decisions equal to the original's.  One addition: ``device``
(``cuda`` unless given) is where every sweep, and every lifetime re-sweep,
runs its float math.  The serving objective prices its plans on the host
(:mod:`repro_torch.core.serving`) and ignores it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union, \
    TYPE_CHECKING

from .cluster import INTER_TOPOLOGIES, TOPOLOGY_CODES
from .placement import Strategy
from .serving import ServingDecision, decide_serving
from .specs import DeploymentRequest, Objective
from .sweep import SweepResult, sweep
from .workloads import (DEFAULT_NPU_HBM_BYTES, MemoryModel,
                        adapter_n_layers, from_model_config)

if TYPE_CHECKING:
    from ..models.config import ModelConfig, ShapeConfig

DEFAULT_FABRICS = ("baseline", "FRED-C", "FRED-D")

# Legacy kwarg-sprawl entry points: new call sites build a
# DeploymentRequest (+ Objective) and go through choose(request).  The
# shim itself stays: it warns and resolves to a bit-identical decision.
_LEGACY_CHOOSE_FNS = ("choose_strategy",)

# The MoE registry entries the epsweep golden pins (both must choose
# ep > 1) and the expert/sequence axes their decision sweep searches.
MOE_ARCHS = ("mixtral-8x7b", "arctic-480b")
EP_SWEEP_KW = dict(ep_candidates=(1, 2, 4, 8), sp_candidates=(1, 2))

# The lifetimesweep golden: every registry arch, decided twice (healthy
# time vs lifetime goodput) on the 20-NPU single-wafer deployment at a
# realistic per-NPU MTBF.  2000 h/NPU ≈ 83 days; at 20 used NPUs the
# system fails every ~100 h, ~7 failures over the 720 h mission — enough
# for elastic-degradation differences to flip decisions (zamba2-2.7b,
# chatglm3-6b, arctic-480b at the pinned settings).
LIFETIME_ARCHS = ("zamba2-2.7b", "llava-next-34b", "whisper-medium",
                  "llama3.2-1b", "chatglm3-6b", "qwen3-32b", "qwen1.5-4b",
                  "arctic-480b", "mixtral-8x7b", "mamba2-1.3b")
LIFETIME_SWEEP_KW = dict(n_npus=20, max_wafers=1)
LIFETIME_MTBF_NPU_HOURS = 2000.0


class InfeasibleModelError(RuntimeError):
    """No (fabric × shape × wafers × strategy × execution) candidate fits
    the per-NPU HBM budget."""


@dataclasses.dataclass(frozen=True)
class AutoStrategyDecision:
    """One row of the auto-strategy decision table."""
    arch: str
    shape: str                        # ShapeConfig.name
    fabric: str
    wafer_shape: Tuple[int, int]      # per-wafer (rows, cols) / (g, k)
    strategy: Strategy
    inter_topology: str               # ring | fully_connected | switch;
                                      # "" when the choice is single-wafer
    hierarchy: Tuple[int, ...]        # inter-level counts ((1,) = single
                                      # wafer, (4,) = flat, (2, 2) = rack×pod)
    execution: str                    # stationary | streaming
    remat: str
    master: bool
    moments_dtype: str
    time_per_sample_s: float
    memory_bytes_per_npu: float
    npu_hbm_bytes: float
    n_candidates: int                 # simulated sweep points (all modes)
    n_infeasible: int                 # failed the memory predicate
    n_dominated: int                  # feasible but off the Pareto front
    sweep_seconds: float
    # lifetime-goodput objective (core/lifetime.py); defaults are the
    # plain time objective so pre-lifetime constructions/goldens are
    # untouched
    objective: str = "time"           # time | goodput
    mtbf_npu_hours: float = math.inf
    goodput_samples_per_s: float = 0.0
    ckpt_write_s: float = 0.0         # repro: unit[s]
    ckpt_interval_s: float = 0.0      # repro: unit[s] (inf: never ckpt)
    useful_fraction: float = 1.0      # healthy-state wall-clock share
    survives_mission: bool = True     # degradation chain never went dead

    @property
    def mp(self) -> int:
        return self.strategy.mp

    @property
    def dp(self) -> int:
        return self.strategy.dp

    @property
    def pp(self) -> int:
        return self.strategy.pp

    @property
    def wafers(self) -> int:
        return self.strategy.wafers

    @property
    def ep(self) -> int:
        return self.strategy.ep

    @property
    def sp(self) -> int:
        return self.strategy.sp

    def golden(self) -> Dict[str, object]:
        """The fields the CI strategy-regression gate pins.  ep/sp appear
        only when > 1, so goldens from the 5-axis era stay byte-identical
        for dense models while MoE decisions pin their EP degree."""
        out = {"mp": self.mp, "dp": self.dp, "pp": self.pp,
               "wafers": self.wafers, "fabric": self.fabric,
               "inter_topology": self.inter_topology,
               "execution": self.execution}
        if self.ep > 1:
            out["ep"] = self.ep
        if self.sp > 1:
            out["sp"] = self.sp
        if self.objective != "time":
            out["objective"] = self.objective
        return out


def _pick_key(r: SweepResult):
    """The deterministic tiebreak chain shared by the time objective's
    Pareto pick and the goodput objective's equal-goodput tiebreak."""
    return (r.time_per_sample, r.memory_bytes_per_npu, r.n_wafers,
            TOPOLOGY_CODES.get(r.inter_topology, -1), len(r.hierarchy),
            r.fabric, r.hierarchy, r.shape,
            (r.strategy.mp, r.strategy.dp, r.strategy.pp,
             r.strategy.ep, r.strategy.sp))


def _pick(front: Sequence[SweepResult]) -> SweepResult:
    """Deterministic choice from the feasible Pareto front: fastest first,
    then smallest footprint, fewest wafers, the cheapest inter-wafer
    interconnect (ring < fully-connected < switch — at 2 wafers all
    three are time-equal, so the tiebreak buys the ring's 2 links over a
    switch or n² point-to-point wiring), then a total lexical tiebreak."""
    return min(front, key=_pick_key)


def _pick_by_goodput(workload_fn, feasible: Sequence[SweepResult],
                     n_npus: int, *, mem: MemoryModel, failure,
                     top_k: int, n_states: int, seed: int,
                     sweep_kw: Dict, device=None):
    """(chosen, LifetimeEstimate) with the highest lifetime goodput.

    Candidates come from the whole *feasible* set (ordered and truncated
    by the time objective's deterministic key), not just the time/memory
    Pareto front — a survivable strategy dominated on healthy time is
    exactly what this objective exists to find.  Fallback re-sweeps are
    shared across candidates via one per-mask cache.  Equal goodput
    falls back to the time objective's tiebreak, so at ``mtbf = ∞``
    (every fraction exactly 1.0) the choice is bit-identical to
    ``_pick``."""
    from .lifetime import evaluate_candidate
    ranked = sorted(feasible, key=_pick_key)[:top_k]
    cache: Dict = {}
    best = None
    for r in ranked:
        est = evaluate_candidate(
            workload_fn, r, n_npus, failure=failure, mem=mem,
            n_states=n_states, seed=seed, sweep_kw=sweep_kw,
            fallback_cache=cache, device=device)
        key = (-est.goodput_samples_per_s,) + _pick_key(r)
        if best is None or key < best[0]:
            best = (key, r, est)
    return best[1], best[2]


def _choose_training(cfg: "ModelConfig", shape: "ShapeConfig", *,
                    n_npus: int = 64,
                    fabrics: Sequence[str] = DEFAULT_FABRICS,
                    max_wafers: int = 2,
                    inter_topologies: Sequence[str] = INTER_TOPOLOGIES,
                    max_levels: int = 1,
                    npu_hbm_bytes: float = DEFAULT_NPU_HBM_BYTES,
                    master: bool = True,
                    moments_dtype: str = "float32",
                    remat: str = "full",
                    min_utilization: float = 0.9,
                    prune_symmetric: bool = True,
                    ep_candidates: Sequence[int] = (1,),
                    sp_candidates: Sequence[int] = (1,),
                    comm_overlap_fraction: float = 0.0,
                    objective: str = "time",
                    mtbf_npu_hours: float = math.inf,
                    mtbf_wafer_hours: float = math.inf,
                    mission_hours: float = 720.0,
                    restart_s: float = 60.0,
                    goodput_top_k: int = 32,
                    n_failure_states: int = 3,
                    failure_seed: int = 0,
                    device=None
                    ) -> AutoStrategyDecision:
    """Return the simulator-chosen, memory-feasible strategy for a cell.

    ``objective="goodput"`` ranks candidates by **lifetime goodput**
    (core/lifetime.py) instead of healthy-iteration time: the top
    ``goodput_top_k`` feasible candidates (by the time-objective order)
    are each pushed through the MTBF / checkpoint / elastic-degradation
    model at ``mtbf_npu_hours`` (and optionally ``mtbf_wafer_hours``)
    over a ``mission_hours`` run, so a slightly-slower strategy that
    keeps running after failures can beat a fragile healthy-time winner.
    At ``mtbf = ∞`` the goodput ranking is bit-identical to the time
    objective (nothing fails, the useful fraction is exactly 1.0).

    Weight-stationary execution is preferred (paper Sec. III-A);
    weight-streaming is tried only when no stationary candidate fits the
    HBM budget, which is how Transformer-1T-class models (arctic-480b)
    become feasible at wafer scale.  Raises :class:`InfeasibleModelError`
    if neither mode yields a feasible point.

    The inter-wafer topology is a first-class decision axis: every
    multi-wafer candidate is evaluated under each ``inter_topologies``
    entry (and, with ``max_levels=2``, each rack/pod stacking), and the
    winning topology/hierarchy is stamped on the decision — the CI
    golden gate diffs it alongside (mp, dp, pp, wafers).

    Serving cells (``shape.kind != "train"``) drop gradients/optimizer
    state and add the KV cache in the memory model; the simulated time is
    still the training-iteration model, so serving decisions rank
    strategies by the same communication structure, not absolute latency.

    ``device`` (``cuda`` unless given) runs the sweeps' float math.
    """
    if objective not in ("time", "goodput"):
        raise ValueError(f"unknown objective {objective!r} — "
                         f"'time' or 'goodput'")
    training = shape.kind == "train"
    mem = MemoryModel(npu_hbm_bytes=npu_hbm_bytes, master=master,
                      moments_dtype=moments_dtype, remat=remat,
                      training=training)
    n_layers = adapter_n_layers(cfg)
    n_candidates = n_infeasible = 0
    sweep_kw = dict(fabrics=fabrics, n_layers=n_layers,
                    min_utilization=min_utilization,
                    max_wafers=max_wafers,
                    inter_topologies=inter_topologies,
                    max_levels=max_levels, memory=mem,
                    prune_symmetric=prune_symmetric,
                    ep_candidates=ep_candidates,
                    sp_candidates=sp_candidates,
                    comm_overlap_fraction=comm_overlap_fraction)
    t0 = time.perf_counter()  # repro: ignore[DETERMINISM] duration metric only
    for execution in ("stationary", "streaming"):
        def wl(st: Strategy, _e=execution):
            return from_model_config(cfg, shape, st, execution=_e)
        results = sweep(wl, n_npus, device=device, **sweep_kw)
        n_candidates += len(results)
        feasible = [r for r in results if r.feasible]
        n_infeasible += len(results) - len(feasible)
        if not feasible:
            continue
        front = [r for r in feasible if r.pareto]
        extra: Dict[str, object] = {}
        if objective == "goodput":
            from .lifetime import FailureModel
            failure = FailureModel(mtbf_npu_hours=mtbf_npu_hours,
                                   mtbf_wafer_hours=mtbf_wafer_hours,
                                   restart_s=restart_s,
                                   mission_hours=mission_hours)
            chosen, est = _pick_by_goodput(
                wl, feasible, n_npus, mem=mem, failure=failure,
                top_k=goodput_top_k, n_states=n_failure_states,
                seed=failure_seed, sweep_kw=sweep_kw, device=device)
            extra = dict(objective="goodput",
                         mtbf_npu_hours=mtbf_npu_hours,
                         goodput_samples_per_s=est.goodput_samples_per_s,
                         ckpt_write_s=est.ckpt_write_s,
                         ckpt_interval_s=est.interval_s,
                         useful_fraction=est.fractions["useful"],
                         survives_mission=est.survives_mission)
        else:
            chosen = _pick(front)
        return AutoStrategyDecision(
            arch=cfg.name, shape=shape.name, fabric=chosen.fabric,
            wafer_shape=chosen.shape, strategy=chosen.strategy,
            inter_topology=chosen.inter_topology,
            hierarchy=chosen.hierarchy,
            execution=execution, remat=remat, master=master,
            moments_dtype=moments_dtype,
            time_per_sample_s=chosen.time_per_sample,
            memory_bytes_per_npu=chosen.memory_bytes_per_npu,
            npu_hbm_bytes=npu_hbm_bytes,
            n_candidates=n_candidates, n_infeasible=n_infeasible,
            n_dominated=len(feasible) - len(front),
            sweep_seconds=time.perf_counter() - t0,  # repro: ignore[DETERMINISM] never feeds goldens
            **extra)
    raise InfeasibleModelError(
        f"{cfg.name}/{shape.name}: none of {n_candidates} candidates fits "
        f"{npu_hbm_bytes / 2**30:.1f} GiB/NPU at {n_npus} NPUs/wafer × "
        f"≤{max_wafers} wafers (try more NPUs, wafers, or a leaner "
        f"OptimConfig)")


# --------------------------------------------------------------------------
# unified entry point: choose(DeploymentRequest) + legacy shim
# --------------------------------------------------------------------------

Decision = Union[AutoStrategyDecision, ServingDecision]

# choose_strategy kwargs that belong to the Objective, not the request
_OBJECTIVE_KWARGS = ("objective", "mtbf_npu_hours", "mtbf_wafer_hours",
                     "mission_hours", "restart_s", "goodput_top_k",
                     "n_failure_states", "failure_seed")


def _build_request(cfg: "ModelConfig", shape: Optional["ShapeConfig"],
                   **kwargs) -> DeploymentRequest:
    """Fold a legacy ``choose_strategy(**kwargs)`` call form into a
    :class:`DeploymentRequest` — the objective-family kwargs move onto
    the :class:`Objective`, everything else maps one-for-one."""
    obj_kw = {k: kwargs.pop(k) for k in _OBJECTIVE_KWARGS if k in kwargs}
    kind = obj_kw.pop("objective", "time")
    objective = kind if isinstance(kind, Objective) else \
        Objective(kind=kind, **obj_kw)
    for f in ("fabrics", "inter_topologies", "ep_candidates",
              "sp_candidates"):
        if f in kwargs:
            kwargs[f] = tuple(kwargs[f])
    return DeploymentRequest(model=cfg, shape=shape, objective=objective,
                             **kwargs)


def choose(request: DeploymentRequest, *, device=None) -> Decision:
    """The one decision entry point — training and serving alike.

    ``request.objective.kind`` dispatches: ``time``/``goodput`` run the
    training sweep (an :class:`AutoStrategyDecision`); ``serving`` runs
    the serving-cell sweep of :mod:`repro_torch.core.serving` (a
    :class:`~repro_torch.core.serving.ServingDecision`, whose request
    profile and SLO live on the Objective — ``request.shape`` is ignored).

    ``device`` (``cuda`` unless given) runs the training sweep's float
    math; the serving sweep prices its plans on the host.
    """
    obj = request.objective
    if obj.kind == "serving":
        return decide_serving(
            request.model, obj, n_npus=request.n_npus,
            fabrics=request.fabrics, max_wafers=request.max_wafers,
            inter_topologies=request.inter_topologies,
            npu_hbm_bytes=request.npu_hbm_bytes,
            comm_overlap_fraction=request.comm_overlap_fraction)
    if request.shape is None:
        raise ValueError(
            f"objective {obj.kind!r} needs DeploymentRequest.shape "
            f"(a ShapeConfig — which cell to train)")
    return _choose_training(
        request.model, request.shape, n_npus=request.n_npus,
        fabrics=request.fabrics, max_wafers=request.max_wafers,
        inter_topologies=request.inter_topologies,
        max_levels=request.max_levels,
        npu_hbm_bytes=request.npu_hbm_bytes, master=request.master,
        moments_dtype=request.moments_dtype, remat=request.remat,
        min_utilization=request.min_utilization,
        prune_symmetric=request.prune_symmetric,
        ep_candidates=request.ep_candidates,
        sp_candidates=request.sp_candidates,
        comm_overlap_fraction=request.comm_overlap_fraction,
        objective=obj.kind, mtbf_npu_hours=obj.mtbf_npu_hours,
        mtbf_wafer_hours=obj.mtbf_wafer_hours,
        mission_hours=obj.mission_hours, restart_s=obj.restart_s,
        goodput_top_k=obj.goodput_top_k,
        n_failure_states=obj.n_failure_states,
        failure_seed=obj.failure_seed, device=device)


def choose_serving_strategy(cfg: "ModelConfig",
                            objective: Optional[Objective] = None, *,
                            n_npus: int = 64,
                            fabrics: Sequence[str] = DEFAULT_FABRICS,
                            max_wafers: int = 2,
                            inter_topologies: Sequence[str] =
                            INTER_TOPOLOGIES,
                            npu_hbm_bytes: float = DEFAULT_NPU_HBM_BYTES,
                            comm_overlap_fraction: float = 0.0,
                            device=None) -> ServingDecision:
    """Elect a serving-cell composition (the ROADMAP's millions-of-users
    item): sugar for :func:`choose` with a serving
    :class:`~repro_torch.core.specs.Objective` (default: the pinned
    :data:`SERVE_OBJECTIVE` — 1M concurrent users, 200 ms p99)."""
    objective = SERVE_OBJECTIVE if objective is None else objective
    if objective.kind != "serving":
        raise ValueError(f"choose_serving_strategy needs a serving "
                         f"Objective, got kind={objective.kind!r}")
    return choose(DeploymentRequest(
        model=cfg, objective=objective, n_npus=n_npus,
        fabrics=tuple(fabrics), max_wafers=max_wafers,
        inter_topologies=tuple(inter_topologies),
        npu_hbm_bytes=npu_hbm_bytes,
        comm_overlap_fraction=comm_overlap_fraction), device=device)


def choose_strategy(cfg: "ModelConfig", shape: "ShapeConfig", *,
                    device=None, **kwargs) -> AutoStrategyDecision:
    """Deprecated legacy call form — build a :class:`DeploymentRequest`
    (+ :class:`Objective`) and call :func:`choose` instead.

    The shim resolves to a bit-identical decision (the kwargs map
    one-for-one onto the request, same defaults), so every pre-redesign
    golden stays byte-stable; it only adds a :class:`DeprecationWarning`.
    """
    warnings.warn(
        "choose_strategy(**kwargs) is deprecated — build a "
        "DeploymentRequest (+ Objective) in repro_torch.core.specs and call "
        "choose(request)", DeprecationWarning, stacklevel=2)
    return choose(_build_request(cfg, shape, **kwargs), device=device)


# --------------------------------------------------------------------------
# decision table (the autostrategy golden)
# --------------------------------------------------------------------------

DECISION_CSV_HEADER = (
    "arch,shape,fabric,shape_a,shape_b,mp,dp,pp,ep,sp,wafers,hierarchy,"
    "inter_topology,execution,remat,"
    "master,moments_dtype,time_per_sample_s,memory_bytes_per_npu,"
    "npu_hbm_bytes,n_candidates,n_infeasible,n_dominated,sweep_s")


def decision_csv_rows(decisions: Sequence[AutoStrategyDecision]) -> List[str]:
    rows = []
    for d in decisions:
        rows.append(
            f"{d.arch},{d.shape},{d.fabric},"
            f"{d.wafer_shape[0]},{d.wafer_shape[1]},"
            f"{d.mp},{d.dp},{d.pp},{d.ep},{d.sp},{d.wafers},"
            f"{'x'.join(map(str, d.hierarchy))},{d.inter_topology},"
            f"{d.execution},{d.remat},"
            f"{int(d.master)},{d.moments_dtype},"
            f"{d.time_per_sample_s:.9g},{d.memory_bytes_per_npu:.9g},"
            f"{d.npu_hbm_bytes:.9g},{d.n_candidates},{d.n_infeasible},"
            f"{d.n_dominated},{d.sweep_seconds:.3f}")
    return rows


def decision_table(archs: Sequence[str], shape_name: str = "train_4k", *,
                   device=None, **kw) -> List[AutoStrategyDecision]:
    """Run :func:`choose` for each registry arch on one shape.

    The policy's frozen per-arch OptimConfig defaults feed the memory
    model (the same settings ``cell_policy`` would return), so the table
    is exactly what ``autostrategy=True`` decides.  ``**kw`` accepts the
    legacy kwarg vocabulary (it is folded into a
    :class:`DeploymentRequest` without the deprecation warning).
    ``device`` (``cuda`` unless given) runs the sweeps."""
    from ..configs.registry import get_config
    from ..models.config import SHAPES_BY_NAME
    from ..parallel.policy import paper_defaults
    shape = SHAPES_BY_NAME[shape_name]
    out = []
    for arch in archs:
        cfg = get_config(arch)
        pcfg, ocfg = paper_defaults(cfg, shape)
        out.append(choose(_build_request(
            cfg, shape, master=ocfg.master,
            moments_dtype=ocfg.moments_dtype, remat=pcfg.remat, **kw),
            device=device))
    return out


def check_goldens(decisions: Sequence[AutoStrategyDecision],
                  golden_path: str) -> List[str]:
    """Diff chosen strategies against the checked-in goldens.

    Returns human-readable mismatch lines (empty = green).  The golden
    file maps ``"{arch}/{shape}"`` → :meth:`AutoStrategyDecision.golden`
    dicts; a cost-model change that silently flips any (mp, dp, pp,
    wafers, fabric, execution) fails the gate."""
    with open(golden_path) as fh:
        goldens = json.load(fh)
    errors = []
    seen = set()
    for d in decisions:
        key = f"{d.arch}/{d.shape}"
        seen.add(key)
        want = goldens.get(key)
        if want is None:
            errors.append(f"{key}: no golden entry (add it to "
                          f"{golden_path})")
            continue
        got = d.golden()
        if got != want:
            errors.append(f"{key}: chosen {got} != golden {want}")
    # a golden with no matching decision means the gate lost coverage
    # (model dropped/renamed in the bench list) — that must fail too
    for key in sorted(set(goldens) - seen):
        errors.append(f"{key}: golden has no matching decision (model "
                      f"removed from the bench list? delete the golden "
                      f"entry if intended)")
    return errors


# --------------------------------------------------------------------------
# lifetimesweep (time-vs-goodput decision pairs + golden gate)
# --------------------------------------------------------------------------

def lifetime_decision_pairs(
        archs: Sequence[str] = LIFETIME_ARCHS,
        shape_name: str = "train_4k",
        mtbf_npu_hours: float = LIFETIME_MTBF_NPU_HOURS, *,
        device=None,
        **kw) -> List[Tuple[AutoStrategyDecision, AutoStrategyDecision]]:
    """Per-arch ``(time, goodput)`` decision pairs at one MTBF.

    Both decisions see the identical sweep space (``LIFETIME_SWEEP_KW``
    unless overridden) — the only difference is the ranking objective,
    so a differing pair is a genuine MTBF-driven strategy flip.
    ``device`` (``cuda`` unless given) runs the sweeps."""
    merged = {**LIFETIME_SWEEP_KW, **kw}
    time_d = decision_table(archs, shape_name, objective="time",
                            device=device, **merged)
    good_d = decision_table(archs, shape_name, objective="goodput",
                            mtbf_npu_hours=mtbf_npu_hours, device=device,
                            **merged)
    return list(zip(time_d, good_d))


def _strategy_signature(d: AutoStrategyDecision) -> Dict[str, object]:
    """The decision fields a flip is judged on (objective key dropped —
    the two columns differ there by construction)."""
    sig = d.golden()
    sig.pop("objective", None)
    sig["wafer_shape"] = list(d.wafer_shape)
    return sig


def lifetime_golden(pair: Tuple[AutoStrategyDecision, AutoStrategyDecision]
                    ) -> Dict[str, object]:
    """One golden entry: both decisions, the flip verdict, and whether
    the goodput winner's degradation chain survives the mission."""
    t, g = pair
    ts, gs = _strategy_signature(t), _strategy_signature(g)
    return {"time": ts, "goodput": gs, "flip": ts != gs,
            "survives_mission": g.survives_mission}


def check_lifetime_goldens(
        pairs: Sequence[Tuple[AutoStrategyDecision, AutoStrategyDecision]],
        golden_path: str) -> List[str]:
    """Diff time/goodput decision pairs against the lifetimesweep golden.

    Same contract as :func:`check_goldens`: returns human-readable
    mismatch lines (empty = green) and flags orphaned golden entries, so
    a cost-model change that silently flips a goodput decision — or
    un-flips one the gate pins — fails the gate."""
    with open(golden_path) as fh:
        goldens = json.load(fh)
    errors = []
    seen = set()
    for pair in pairs:
        t = pair[0]
        key = f"{t.arch}/{t.shape}"
        seen.add(key)
        want = goldens.get(key)
        if want is None:
            errors.append(f"{key}: no golden entry (add it to "
                          f"{golden_path})")
            continue
        got = lifetime_golden(pair)
        if got != want:
            errors.append(f"{key}: decided {got} != golden {want}")
    for key in sorted(set(goldens) - seen):
        errors.append(f"{key}: golden has no matching decision (model "
                      f"removed from the bench list? delete the golden "
                      f"entry if intended)")
    return errors


# --------------------------------------------------------------------------
# servesweep (serving-cell decisions + golden gate)
# --------------------------------------------------------------------------

# The servesweep golden: one small / one north-star dense model + one
# MoE, decided under the pinned production objective — 1M concurrent
# users on a 60 s think time (16.7k requests/s offered), 1024-token
# prompts, 256 generated tokens, 200 ms p99 TTFT.  qwen3-32b under this
# objective IS the ROADMAP's "how many wafers serve 1M concurrent users
# at a 200 ms p99" question; its total_wafers is pinned in the golden.
SERVESWEEP_ARCHS = ("llama3.2-1b", "qwen3-32b", "mixtral-8x7b")
SERVE_OBJECTIVE = Objective.serving(
    target_p99_ms=200.0, concurrent_users=1_000_000, think_time_s=60.0,
    prompt_tokens=1024, output_tokens=256)
SERVE_SWEEP_KW = dict(n_npus=64, max_wafers=2)


def serving_decision_table(archs: Sequence[str] = SERVESWEEP_ARCHS,
                           objective: Optional[Objective] = None, *,
                           device=None, **kw) -> List[ServingDecision]:
    """Run :func:`choose` with a serving objective for each arch.  The
    serving sweep prices its plans on the host; ``device`` is passed on to
    :func:`choose` all the same."""
    from ..configs.registry import get_config
    objective = SERVE_OBJECTIVE if objective is None else objective
    merged = {**SERVE_SWEEP_KW, **kw}
    return [choose(DeploymentRequest(model=get_config(arch),
                                     objective=objective, **merged),
                   device=device)
            for arch in archs]


def check_serving_goldens(decisions: Sequence[ServingDecision],
                          golden_path: str) -> List[str]:
    """Diff serving-cell decisions against the servesweep golden.

    Same contract as :func:`check_goldens`: human-readable mismatch
    lines (empty = green) plus orphan detection, keyed by arch — a cost-
    model change that silently moves the pinned wafer count (or flips a
    placement/fabric election) fails the CI gate."""
    with open(golden_path) as fh:
        goldens = json.load(fh)
    errors = []
    seen = set()
    for d in decisions:
        seen.add(d.arch)
        want = goldens.get(d.arch)
        if want is None:
            errors.append(f"{d.arch}: no golden entry (add it to "
                          f"{golden_path})")
            continue
        got = d.golden()
        if got != want:
            errors.append(f"{d.arch}: decided {got} != golden {want}")
    for key in sorted(set(goldens) - seen):
        errors.append(f"{key}: golden has no matching decision (model "
                      f"removed from the bench list? delete the golden "
                      f"entry if intended)")
    return errors
