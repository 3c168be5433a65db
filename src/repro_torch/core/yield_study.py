"""Yield studies: does the auto-chosen strategy survive wafer defects?

The PyTorch port's own copy of ``repro.core.yield_study``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_decide.py`` holds
its results equal to the original's.  One addition: ``device`` (``cuda``
unless given) is where the sweeps run their float math.

Wafer-scale integration ships defective NPUs (the yield argument behind
Hecaton-style chiplet papers and the reason Cerebras reserves spare
cores); a strategy tuned for the pristine wafer is only deployable if it
— or a cheap fallback — still runs on the wafer you actually get.  This
module quantifies that:

  1. run the defect-free sweep and pick the winner exactly the way
     auto-strategy does (same Pareto front, same tiebreak),
  2. draw ``n_masks`` independent defect masks at a target dead-NPU rate
     (seeded: ``seed0 + i`` — the study is reproducible row for row),
  3. for each mask, check whether the winner *survives*: enough healthy
     NPUs per wafer, mesh still connected (baseline), optionally still
     conflict-free-routable (FRED), and the degraded simulation actually
     runs — recording the degraded time and slowdown when it does,
  4. when the winner dies, re-run the sweep *under the mask* and record
     the fallback decision the auto-strategy would pick on that wafer.

The result is a :class:`YieldReport`: survival rate, per-mask outcomes,
slowdown statistics, and the fallback table; :meth:`YieldReport.golden`
is what ``tests/goldens/faultsweep.json`` pins.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .cluster import TOPOLOGY_CODES
from .defects import DefectMask, mesh_connected, normalize, sample_mask
from .placement import Strategy
from .routing import strategy_routable
from .sweep import SweepResult, _simulator, sweep
from .workloads import Workload

DEFAULT_FABRICS = ("baseline", "FRED-C", "FRED-D")


def pick_winner(results: Sequence[SweepResult]) -> SweepResult:
    """Deterministic choice from a sweep's Pareto front — the same
    tiebreak chain as ``autostrategy._pick`` (fastest, then smallest
    footprint, fewest wafers, cheapest inter-wafer topology, lexical)."""
    front = [r for r in results if r.pareto]
    if not front:
        raise ValueError("sweep produced no Pareto point (no feasible "
                         "candidate under the mask/memory model)")
    return min(front, key=lambda r: (
        r.time_per_sample, r.memory_bytes_per_npu, r.n_wafers,
        TOPOLOGY_CODES.get(r.inter_topology, -1), len(r.hierarchy),
        r.fabric, r.hierarchy, r.shape,
        (r.strategy.mp, r.strategy.dp, r.strategy.pp)))


@dataclasses.dataclass(frozen=True)
class MaskOutcome:
    """One defect draw's verdict on the defect-free winner."""
    seed: int
    n_dead: int                       # dead NPUs in the draw (after the
                                      # sampler's connectivity demotion)
    survived: bool
    reason: str                       # "" when survived; else capacity |
                                      # disconnected | unroutable | eval: …
    degraded_time_s: float            # winner's iteration time under the
                                      # mask (0.0 when it died)
    slowdown: float                   # degraded / healthy time (0.0 dead)
    fallback: Optional[SweepResult] = None   # degraded re-sweep winner
                                             # (None: survived, fallback
                                             # disabled, or none feasible)


@dataclasses.dataclass
class YieldReport:
    """Aggregate verdict of one yield study."""
    workload: str
    n_npus: int                       # per wafer
    dead_npu_rate: float              # sampler target rate
    winner: SweepResult               # defect-free choice
    outcomes: List[MaskOutcome]
    study_seconds: float

    @property
    def n_masks(self) -> int:
        return len(self.outcomes)

    @property
    def n_survived(self) -> int:
        return sum(1 for o in self.outcomes if o.survived)

    @property
    def survival_rate(self) -> float:
        return self.n_survived / max(self.n_masks, 1)

    @property
    def n_fallback(self) -> int:
        return sum(1 for o in self.outcomes
                   if not o.survived and o.fallback is not None)

    @property
    def mean_slowdown(self) -> float:
        """Mean degraded/healthy ratio over the surviving draws (1.0 ≡
        defects cost nothing on this winner's communication paths)."""
        s = [o.slowdown for o in self.outcomes if o.survived]
        return sum(s) / len(s) if s else 0.0

    @property
    def worst_slowdown(self) -> float:
        return max((o.slowdown for o in self.outcomes if o.survived),
                   default=0.0)

    def golden(self) -> Dict[str, object]:
        """The decisions the CI fault gate pins: the defect-free winner,
        the survival tally, and every degraded fallback decision."""
        w = self.winner
        out: Dict[str, object] = {
            "winner": {"fabric": w.fabric, "mp": w.strategy.mp,
                       "dp": w.strategy.dp, "pp": w.strategy.pp,
                       "wafers": w.strategy.wafers,
                       "inter_topology": w.inter_topology},
            "survived": f"{self.n_survived}/{self.n_masks}",
        }
        fb: Dict[str, object] = {}
        for o in self.outcomes:
            if o.survived or o.fallback is None:
                continue
            f = o.fallback
            fb[str(o.seed)] = {"fabric": f.fabric, "mp": f.strategy.mp,
                               "dp": f.strategy.dp, "pp": f.strategy.pp,
                               "wafers": f.strategy.wafers}
        out["fallbacks"] = fb
        return out

    def summary(self) -> str:
        w = self.winner
        lines = [
            f"{self.workload}: winner {w.fabric} {w.shape[0]}x{w.shape[1]} "
            f"mp={w.strategy.mp} dp={w.strategy.dp} pp={w.strategy.pp} "
            f"wafers={w.strategy.wafers}",
            f"  {self.n_masks} masks at {self.dead_npu_rate:.1%} dead NPUs: "
            f"{self.n_survived} survive ({self.survival_rate:.1%}), "
            f"{self.n_fallback} recover via fallback",
        ]
        if self.n_survived:
            lines.append(f"  slowdown when surviving: mean "
                         f"{self.mean_slowdown:.3f}x, worst "
                         f"{self.worst_slowdown:.3f}x")
        for o in self.outcomes:
            if not o.survived and o.fallback is None:
                lines.append(f"  seed {o.seed}: DEAD ({o.reason}), "
                             f"no feasible fallback")
        return "\n".join(lines)


YIELD_CSV_HEADER = (
    "workload,n_npus,dead_npu_rate,seed,n_dead,survived,reason,"
    "healthy_time_s,degraded_time_s,slowdown,"
    "fallback_fabric,fallback_mp,fallback_dp,fallback_pp,fallback_wafers,"
    "fallback_time_s")


def yield_csv_rows(report: YieldReport) -> List[str]:
    """One row per sampled mask; schema in benchmarks/README.md."""
    rows = []
    healthy = report.winner.total
    for o in report.outcomes:
        f = o.fallback
        rows.append(
            f"{report.workload},{report.n_npus},"
            f"{report.dead_npu_rate:.9g},{o.seed},{o.n_dead},"
            f"{int(o.survived)},{o.reason.split(',')[0]},"
            f"{healthy:.9g},{o.degraded_time_s:.9g},{o.slowdown:.9g},"
            + (f"{f.fabric},{f.strategy.mp},{f.strategy.dp},"
               f"{f.strategy.pp},{f.strategy.wafers},{f.total:.9g}"
               if f is not None else ",,,,,"))
    return rows


def _winner_survives(winner: SweepResult, workload_fn, mask: DefectMask,
                     n_npus: int, compute_efficiency: float,
                     check_routing: bool, uplinks: Optional[int],
                     inter_kw: Dict[str, float]
                     ) -> Tuple[bool, str, float]:
    """(survived, reason, degraded_time_s) for the winner under ``mask``."""
    st = winner.strategy
    per_wafer = st.mp * st.pp * (st.dp // max(st.wafers, 1))
    if per_wafer > mask.n_healthy:
        return False, (f"capacity: needs {per_wafer} healthy NPUs/wafer, "
                       f"mask leaves {mask.n_healthy}"), 0.0
    if winner.fabric == "baseline" \
            and not mesh_connected(mask, *winner.shape):
        return False, "disconnected: mask severs this mesh shape", 0.0
    if check_routing and winner.fabric != "baseline" \
            and not strategy_routable(st, winner.shape, uplinks=uplinks,
                                      defects=mask):
        return False, "unroutable: conflict-free routing fails", 0.0
    sim = _simulator(
        winner.fabric, winner.shape, n_npus, {}, compute_efficiency,
        n_wafers=winner.n_wafers,
        hierarchy=winner.hierarchy if winner.n_wafers > 1 else None,
        inter_topology=winner.inter_topology, defects=mask, **inter_kw)
    try:
        br = sim.run(workload_fn(st))
    except ValueError as e:
        return False, f"eval: {e}", 0.0
    return True, "", br.total


def yield_study(workload_fn: Callable[[Strategy], Workload], n_npus: int,
                *,
                fabrics: Sequence[str] = DEFAULT_FABRICS,
                n_masks: int = 32,
                dead_npu_rate: float = 0.02,
                dead_link_rate: float = 0.0,
                dead_uplink_rate: float = 0.0,
                seed0: int = 0,
                masks: Optional[Sequence[DefectMask]] = None,
                n_layers: Optional[int] = None,
                min_utilization: float = 0.9,
                max_wafers: int = 1,
                inter_topologies: Sequence[str] = ("ring",),
                max_levels: int = 1,
                memory=None,
                prune_symmetric: bool = False,
                check_routing: bool = False,
                fallback: bool = True,
                compute_efficiency: float = 0.45,
                engine: str = "batched",
                inter_wafer_links: int = 32,
                inter_wafer_bw: float = 400e9,
                inter_wafer_latency: float = 5e-7,
                device=None) -> YieldReport:
    """Run the yield study for one workload at ``n_npus`` NPUs per wafer.

    The defect-free sweep (same knobs auto-strategy uses) picks the
    winner; each of ``n_masks`` draws (``sample_mask`` at
    ``dead_npu_rate`` / ``dead_link_rate`` / ``dead_uplink_rate``, seeds
    ``seed0 .. seed0+n_masks-1``) then tests it.  Pass ``masks``
    explicitly to study hand-built draws instead of sampling (``n_masks``
    and the rates are ignored).  ``fallback=True`` re-sweeps under every
    killing mask to record the degraded auto-strategy decision.

    Mask sampling is fabric-aware: a baseline winner samples with its
    mesh shape (so link kills land on real edges and stranded NPUs are
    demoted), a FRED winner with its group count and physical uplink
    multiplicity.

    ``device`` (``cuda`` unless given) runs every sweep's float math.
    """
    t0 = time.perf_counter()  # repro: ignore[DETERMINISM] duration metric only
    sweep_kw = dict(
        fabrics=fabrics, n_layers=n_layers,
        min_utilization=min_utilization, max_wafers=max_wafers,
        inter_topologies=inter_topologies, max_levels=max_levels,
        memory=memory, prune_symmetric=prune_symmetric,
        compute_efficiency=compute_efficiency, engine=engine,
        inter_wafer_links=inter_wafer_links,
        inter_wafer_bw=inter_wafer_bw,
        inter_wafer_latency=inter_wafer_latency, device=device)
    inter_kw = dict(inter_wafer_links=inter_wafer_links,
                    inter_wafer_bw=inter_wafer_bw,
                    inter_wafer_latency=inter_wafer_latency)
    healthy = sweep(workload_fn, n_npus, **sweep_kw)
    winner = pick_winner(healthy)
    healthy_t = winner.total

    uplinks = None
    sample_kw: Dict[str, object] = {}
    if winner.fabric == "baseline":
        sample_kw["mesh_shape"] = winner.shape
    else:
        sim0 = _simulator(winner.fabric, winner.shape, n_npus, {},
                          compute_efficiency)
        uplinks = sim0.fred.uplinks_per_l1()
        sample_kw["n_groups"] = winner.shape[0]
        sample_kw["uplinks_per_l1"] = uplinks

    if masks is None:
        masks = [sample_mask(n_npus, dead_npu_rate=dead_npu_rate,
                             dead_link_rate=dead_link_rate,
                             dead_uplink_rate=dead_uplink_rate,
                             seed=seed0 + i, **sample_kw)
                 for i in range(n_masks)]

    outcomes: List[MaskOutcome] = []
    for mask in masks:
        seed = mask.seed
        mask = normalize(mask)
        if mask is None:
            # an all-healthy draw trivially survives at the healthy time
            outcomes.append(MaskOutcome(seed=seed, n_dead=0, survived=True,
                                        reason="",
                                        degraded_time_s=healthy_t,
                                        slowdown=1.0))
            continue
        ok, reason, t = _winner_survives(
            winner, workload_fn, mask, n_npus, compute_efficiency,
            check_routing, uplinks, inter_kw)
        fb: Optional[SweepResult] = None
        if not ok and fallback:
            try:
                fb = pick_winner(sweep(workload_fn, n_npus, defects=mask,
                                       **sweep_kw))
            except ValueError:
                fb = None               # nothing feasible on this wafer
        outcomes.append(MaskOutcome(
            seed=seed, n_dead=len(mask.dead_npus), survived=ok,
            reason=reason, degraded_time_s=t,
            slowdown=(t / healthy_t if ok and healthy_t > 0 else 0.0),
            fallback=fb))
    return YieldReport(workload=workload_fn(winner.strategy).name,
                       n_npus=n_npus, dead_npu_rate=dead_npu_rate,
                       winner=winner, outcomes=outcomes,
                       study_seconds=time.perf_counter() - t0)  # repro: ignore[DETERMINISM] never feeds goldens


def model_yield_study(arch: str, shape_name: str = "train_4k", *,
                      n_npus: int = 20, device=None, **kw) -> YieldReport:
    """Yield study for a registry model under the policy's frozen
    defaults — the memory model and workload are exactly what
    ``autostrategy.choose_strategy`` would use.  Tries weight-stationary
    execution first, weight-streaming if nothing stationary is feasible
    (mirroring the auto-strategy fallback chain).  ``device`` (``cuda``
    unless given) runs the sweeps."""
    from ..configs.registry import get_config
    from ..models.config import SHAPES_BY_NAME
    from ..parallel.policy import paper_defaults
    from .workloads import MemoryModel, adapter_n_layers, from_model_config

    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    pcfg, ocfg = paper_defaults(cfg, shape)
    mem = MemoryModel(master=ocfg.master, moments_dtype=ocfg.moments_dtype,
                      remat=pcfg.remat, training=shape.kind == "train")
    kw.setdefault("memory", mem)
    kw.setdefault("n_layers", adapter_n_layers(cfg))
    last: Optional[ValueError] = None
    for execution in ("stationary", "streaming"):
        def wl(st: Strategy, _e=execution) -> Workload:
            return from_model_config(cfg, shape, st, execution=_e)
        try:
            return yield_study(wl, n_npus, device=device, **kw)
        except ValueError as e:
            last = e
    raise ValueError(f"{arch}/{shape_name}: no feasible strategy at "
                     f"{n_npus} NPUs in either execution mode") from last
