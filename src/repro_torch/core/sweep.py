"""Strategy/topology sweep engine (LIBRA/WATOS-style co-exploration).

The PyTorch port's own copy of ``repro.core.sweep`` (the port imports
nothing of the JAX package); ``tests/test_torch_core.py`` holds its results
equal to the original's.  One difference: ``engine="batched"`` runs the
float math on ``device`` (``cuda`` unless given,
:mod:`repro_torch.core.batch_engine`).

The paper's core claim is that FRED stays efficient across *arbitrary*
parallelization strategies; this module makes that explorable.  For a given
NPU count it enumerates

  * every valid (mp, dp, pp) 3D-parallel strategy (divisor triples, with
    an optional utilization floor so near-full wafers count too — the
    paper's Transformer-17B uses 18 of 20 NPUs), and
  * every wafer shape realizing that NPU count: rows×cols meshes for the
    baseline, n_groups×group_size almost-fat-trees for FRED, and
  * (``max_wafers > 1``) every wafer count of a multi-wafer cluster —
    the wafer is the manufacturing unit, so 2 wafers double the NPUs and
    the DP axis splits across them (Strategy.wafers, core/cluster.py) —
    crossed with every inter-wafer topology in ``inter_topologies``
    (ring / fully_connected / switch) and every hierarchy stacking of
    the wafer count into ≤ ``max_levels`` rack/pod levels
    (:func:`hierarchy_specs`),

then evaluates the cross-product under one of two bit-identical engines:
the default ``engine="batched"`` vectorizes all strategies of each
(fabric, shape, wafer count) configuration as NumPy array ops
(:mod:`repro_torch.core.batch_engine` — what makes exhaustive 500+-NPU sweeps
fit the CI budget), while ``engine="scalar"`` walks
:class:`repro_torch.core.simulator.Simulator` per point as the reference
oracle.  Scalar collective times are memoized per (fabric, shape) in a
bounded LRU — strategies share collective calls heavily (the same
wafer-wide or per-group All-Reduce appears in many strategies) — and
placement groups are memoized per (strategy, wafer count, wafer size)
across the whole process.

Reporting: :func:`pareto_front` extracts the strategies not dominated on
(time-per-sample, parameter-bytes-per-NPU) — the throughput/memory
trade-off DP replication buys — and :func:`to_csv_rows` emits the schema
documented in ``benchmarks/README.md``.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .cluster import INTER_TOPOLOGIES
from .defects import DefectMask, normalize
from .placement import Strategy
from .simulator import Breakdown, LRUCache, Simulator
from .specs import ClusterSpec, FabricSpec
from .workloads import (MemoryModel, Workload, is_feasible,
                        memory_bytes_per_npu, transformer)

FABRICS = ("baseline", "FRED-A", "FRED-B", "FRED-C", "FRED-D")
ENGINES = ("batched", "scalar")

# bound on the shared collective memo — a 500+-NPU multi-wafer scalar
# sweep would otherwise grow it without limit (the batched engine keeps
# its own per-pattern structural tables and never touches this)
COLLECTIVE_CACHE_SIZE = 1 << 17


# --------------------------------------------------------------------------
# search spaces
# --------------------------------------------------------------------------

def factor_pairs(n: int) -> List[Tuple[int, int]]:
    """(a, b) with a·b = n and a ≥ b (orientation is symmetric for both
    fabric models)."""
    out = []
    b = 1
    while b * b <= n:
        if n % b == 0:
            out.append((n // b, b))
        b += 1
    return out


def mesh_shapes(n_npus: int) -> List[Tuple[int, int]]:
    """rows×cols meshes realizing ``n_npus`` (degenerate 1×N included —
    the model handles it; the sweep ranks it out on its own merits)."""
    return factor_pairs(n_npus)


def fred_shapes(n_npus: int) -> List[Tuple[int, int]]:
    """n_groups×group_size almost-fat-trees realizing ``n_npus``.  The
    single-group shape (1, n) is a pure crossbar — valid but excluded:
    the 2-level tree needs ≥ 2 L1 groups."""
    out: List[Tuple[int, int]] = []
    for a, b in factor_pairs(n_npus):
        for g, k in ((b, a), (a, b)):       # narrow groups first
            if g >= 2 and (g, k) not in out:
                out.append((g, k))
    return out


def cluster_shapes(n_npus: int, max_wafers: int,
                   shape_fn: Callable[[int], List[Tuple[int, int]]]
                   = fred_shapes) -> List[Tuple[int, Tuple[int, int]]]:
    """(n_wafers, per-wafer shape) pairs for every wafer count up to
    ``max_wafers``.  ``n_npus`` is *per wafer* — the wafer is the
    manufacturing unit, so scale-out multiplies the NPU count (a 2-wafer
    cluster of 20-NPU wafers has 40 NPUs).  ``max_wafers=1`` reduces to
    ``[(1, s) for s in shape_fn(n_npus)]``."""
    if max_wafers < 1:
        raise ValueError(f"max_wafers must be ≥ 1, got {max_wafers}")
    return [(w, s) for w in range(1, max_wafers + 1)
            for s in shape_fn(n_npus)]


def hierarchy_specs(n_wafers: int, max_levels: int = 1
                    ) -> List[Tuple[int, ...]]:
    """Stackings of ``n_wafers`` into ≤ ``max_levels`` inter levels
    (level counts innermost first, every level ≥ 2 wafers/units): 4
    wafers at 2 levels → the flat ``(4,)`` ring-of-wafers and the
    ``(2, 2)`` rack-of-2 × pod-of-2.  Deterministic order: flat spec
    first, then ascending innermost count."""
    if max_levels < 1:
        raise ValueError(f"max_levels must be ≥ 1, got {max_levels}")
    if n_wafers == 1:
        return [(1,)]
    specs: List[Tuple[int, ...]] = [(n_wafers,)]
    if max_levels >= 2:
        for c1 in range(2, n_wafers // 2 + 1):
            if n_wafers % c1:
                continue
            for rest in hierarchy_specs(n_wafers // c1, max_levels - 1):
                spec = (c1,) + rest
                if all(c >= 2 for c in spec):
                    specs.append(spec)
    return specs


def hierarchy_configs(n_npus: int, max_wafers: int,
                      shape_fn: Callable[[int], List[Tuple[int, int]]]
                      = fred_shapes,
                      inter_topologies: Sequence[str] = ("ring",),
                      max_levels: int = 1
                      ) -> List[Tuple[int, Tuple[int, int],
                                      Tuple[int, ...], str]]:
    """(n_wafers, per-wafer shape, hierarchy, inter topology) tuples —
    the full scale-out configuration axis of the sweep.  Single-wafer
    configurations carry the degenerate ``((1,), "")`` hierarchy/topology
    so the defaults reduce exactly to :func:`cluster_shapes` order."""
    if max_wafers < 1:
        raise ValueError(f"max_wafers must be ≥ 1, got {max_wafers}")
    for t in inter_topologies:
        if t not in INTER_TOPOLOGIES:
            raise ValueError(f"unknown inter topology {t!r}; expected "
                             f"a subset of {INTER_TOPOLOGIES}")
    out: List[Tuple[int, Tuple[int, int], Tuple[int, ...], str]] = []
    for w in range(1, max_wafers + 1):
        for s in shape_fn(n_npus):
            if w == 1:
                out.append((1, s, (1,), ""))
                continue
            for hier in hierarchy_specs(w, max_levels):
                for topo in inter_topologies:
                    out.append((w, s, hier, topo))
    return out


def _expand_ep_sp(st: Strategy, ep_candidates: Sequence[int],
                  sp_candidates: Sequence[int]) -> List[Strategy]:
    """``st`` followed by its valid (ep, sp) variants: ep must divide the
    per-wafer DP degree (EP groups stay within a wafer) and sp must divide
    mp (SP splits activations across MP peers).  The base (ep=1, sp=1)
    point is never duplicated, so the default candidates ``(1,)`` return
    ``[st]`` — bit-identical enumeration order."""
    out = [st]
    for ep in ep_candidates:
        for sp in sp_candidates:
            if ep == 1 and sp == 1:
                continue
            if ep > 1 and st.dp_per_wafer % ep != 0:
                continue
            if sp > 1 and st.mp % sp != 0:
                continue
            out.append(dataclasses.replace(st, ep=ep, sp=sp))
    return out


def strategy_space(n_npus: int, n_layers: Optional[int] = None,
                   min_utilization: float = 0.9,
                   n_wafers: int = 1,
                   ep_candidates: Sequence[int] = (1,),
                   sp_candidates: Sequence[int] = (1,)) -> List[Strategy]:
    """All (mp, dp, pp) with mp·dp·pp ≤ n_npus and utilization ≥ the floor.

    ``n_layers`` (when given) keeps only pp that divide the layer count —
    GPipe stages must hold whole layers.  Deterministic order: descending
    worker count, then (mp, dp, pp) lexicographic.

    ``n_wafers > 1`` adds the wafer axis: after each base triple, the
    wafer-split variants ``Strategy(mp, dp, pp, wafers=w)`` for every
    2 ≤ w ≤ n_wafers dividing dp (DP replicas map whole onto wafers;
    per-wafer capacity is checked later, at placement/sweep time).

    ``ep_candidates``/``sp_candidates`` expand each emitted strategy with
    its valid expert-/sequence-parallel variants (:func:`_expand_ep_sp`);
    the defaults ``(1,)`` keep the 5-axis space byte-identical."""
    floor = max(1, int(min_utilization * n_npus))
    out = []
    for used in range(n_npus, floor - 1, -1):
        for mp, rest in ((m, used // m) for m in range(1, used + 1)
                         if used % m == 0):
            for dp, pp in ((d, rest // d) for d in range(1, rest + 1)
                           if rest % d == 0):
                if n_layers is not None and n_layers % pp != 0:
                    continue
                out.extend(_expand_ep_sp(Strategy(mp, dp, pp),
                                         ep_candidates, sp_candidates))
                for wf in range(2, n_wafers + 1):
                    if dp % wf == 0:
                        out.extend(_expand_ep_sp(
                            Strategy(mp, dp, pp, wafers=wf),
                            ep_candidates, sp_candidates))
    return out


# --------------------------------------------------------------------------
# canonical-form dedup (symmetry pruning)
# --------------------------------------------------------------------------

def sim_signature(st: Strategy, w: Workload) -> Tuple:
    """Canonical form of a divisor triple: the exact inputs
    :meth:`Simulator.run` reads for ``w`` under ``st``.

    Two strategies with equal signatures produce bit-identical Breakdowns
    (and sweep objectives) on *any* fabric/shape, so the sweep simulates
    only one representative per signature and replicates the result.

    Note the often-assumed mp↔dp swap symmetry does NOT hold in this
    model — (mp=9, dp=2) and (mp=2, dp=9) differ in compute shard, MP
    collective group, DP gradient bytes AND both Pareto objectives
    (tests/test_autostrategy.py pins a numeric counterexample) — which is
    exactly why the dedup keys on the simulation inputs instead of a
    syntactic (sorted-triple) canonical form: pruning can never change
    the Pareto front, only skip provably redundant simulator calls.
    """
    layers_per_stage = -(-w.n_layers // st.pp)
    microbatches = 8 if (st.pp > 1 and w.execution == "stationary") else \
        max(st.pp, 1)
    act_bytes = w.act_bytes_per_sample * w.samples_per_dp
    # components are guarded exactly as Simulator.run guards the terms, so
    # a skipped term contributes nothing to the canonical form
    ep_active = st.ep > 1 and w.a2a_bytes_per_sample_layer > 0
    mp_ar = w.mp_allreduce_per_layer
    if ep_active and mp_ar:       # the A2A subsumes one MP sync (run())
        mp_ar = mp_ar - 1
    mp_term = (st.mp, st.dp * st.pp, act_bytes, mp_ar) \
        if (st.mp > 1 and mp_ar) else None
    pp_term = (act_bytes, microbatches, st.pp, st.sp) if st.pp > 1 else None
    dp_term = ((st.dp, st.mp, st.pp, w.params_per_layer / st.mp)
               if (st.dp > 1 and w.execution == "stationary") else None)
    ep_term = ((st.ep, st.mp * st.pp,
                st.mp * st.pp * st.dp // (st.ep * st.wafers),
                w.a2a_bytes_per_sample_layer * w.samples_per_dp)
               if ep_active else None)
    stream_term = ((w.param_bytes_total / st.pp,
                    w.minibatch * w.act_bytes_per_sample)
                   if w.execution == "streaming" else None)
    return (
        w.name, w.execution, st.wafers,
        # compute: per-NPU FLOPs share and pipeline pacing
        w.flops_fwd_per_sample_layer * w.samples_per_dp / st.mp,
        layers_per_stage, microbatches,
        mp_term, pp_term, dp_term, ep_term, stream_term,
        # normalizers / objectives (incl. the memory-model inputs: seq,
        # per-MP-shard layer params, KV bytes, the EP/SP memory factors —
        # exact under any MemoryModel)
        w.samples_per_dp, w.minibatch, w.seq,
        w.params_per_layer / st.mp, w.kv_bytes_per_sample_layer,
        w.param_bytes_total / (st.mp * st.pp),
        st.ep, st.sp, w.expert_param_fraction,
    )


# --------------------------------------------------------------------------
# sweep
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    fabric: str
    shape: Tuple[int, int]            # (rows, cols) or (n_groups, group_size)
    strategy: Strategy
    breakdown: Breakdown
    minibatch: int
    param_bytes_per_npu: float
    routable: Optional[bool] = None   # FRED only, when check_routing=True
    pareto: bool = False
    n_wafers: int = 1                 # wafers in the cluster (shape is
                                      # per wafer; total NPUs scale with it)
    inter_wafer_bw: float = 0.0       # aggregate wafer↔wafer B/s (0 ≡ n/a)
    memory_bytes_per_npu: float = 0.0  # per-NPU footprint under the sweep's
                                       # MemoryModel (0 when none given)
    feasible: Optional[bool] = None    # fits npu_hbm_bytes; None = not
                                       # evaluated (no MemoryModel)
    hierarchy: Tuple[int, ...] = (1,)  # inter-level counts, innermost
                                       # first ((4,) = flat ring of 4
                                       # wafers, (2, 2) = rack×pod)
    inter_topology: str = ""           # ring | fully_connected | switch;
                                       # "" on a single wafer
    defect_rate: float = 0.0           # dead-NPU fraction of the sweep's
                                       # DefectMask (0.0 = defect-free)
    defect_seed: int = -1              # mask sampler seed; -1 = no mask
                                       # (or a hand-built one)
    degraded_time_s: float = 0.0       # breakdown.total under the mask;
                                       # 0.0 on a defect-free sweep

    @property
    def total(self) -> float:
        return self.breakdown.total

    @property
    def time_per_sample(self) -> float:
        return self.breakdown.total / max(self.minibatch, 1)

    @property
    def n_npus(self) -> int:
        return self.shape[0] * self.shape[1] * self.n_wafers


def scaled_n_io(n_npus: int) -> int:
    """I/O controllers at the paper's per-NPU density (18 on 20), kept ≥ 1.
    Used for EVERY fabric in the sweep so cross-fabric comparisons share
    one I/O budget (at 20 NPUs this equals the 5×4 mesh's border-derived
    18, so the paper point is unchanged)."""
    return max(1, round(18 * n_npus / 20))


def _simulator(fabric: str, shape: Tuple[int, int], n_npus: int,
               cache: dict, compute_efficiency: float,
               n_wafers: int = 1,
               hierarchy: Optional[Tuple[int, ...]] = None,
               inter_topology: str = "",
               defects: Optional[DefectMask] = None,
               comm_overlap_fraction: float = 0.0,
               **inter_kw) -> Simulator:
    """``n_npus`` is per wafer; ``inter_kw`` forwards the inter-wafer link
    parameters (inter_wafer_links/bw/latency) when n_wafers > 1, and
    ``hierarchy``/``inter_topology`` shape the inter levels (single ring
    level when unset — the single-ring model).  Construction goes through the
    consolidated FabricSpec/ClusterSpec API (core/specs.py)."""
    spec = FabricSpec(
        mesh_shape=shape if fabric == "baseline" else None,
        fred_shape=None if fabric == "baseline" else shape,
        n_io=scaled_n_io(n_npus), defects=defects)
    cluster_spec = None
    if n_wafers > 1:
        ckw = dict(n_wafers=n_wafers, **inter_kw)
        if hierarchy is not None:
            ckw["hierarchy"] = hierarchy
        if inter_topology:
            ckw["inter_topology"] = inter_topology
        cluster_spec = ClusterSpec(**ckw)
    return Simulator(fabric, compute_efficiency=compute_efficiency,
                     spec=spec, cluster_spec=cluster_spec,
                     collective_cache=cache,
                     comm_overlap_fraction=comm_overlap_fraction)


def sweep(workload_fn: Callable[[Strategy], Workload], n_npus: int,
          fabrics: Sequence[str] = ("baseline", "FRED-C", "FRED-D"),
          strategies: Optional[Sequence[Strategy]] = None,
          n_layers: Optional[int] = None,
          min_utilization: float = 0.9,
          check_routing: bool = False,
          compute_efficiency: float = 0.45,
          max_wafers: int = 1,
          # the inter-wafer links of the modelled cluster, not the card's
          inter_wafer_links: int = 32,
          inter_wafer_bw: float = 400e9,
          inter_wafer_latency: float = 5e-7,
          inter_topologies: Sequence[str] = ("ring",),
          max_levels: int = 1,
          memory: Optional[MemoryModel] = None,
          prune_symmetric: bool = False,
          engine: str = "batched",
          defects: Optional[DefectMask] = None,
          ep_candidates: Sequence[int] = (1,),
          sp_candidates: Sequence[int] = (1,),
          comm_overlap_fraction: float = 0.0,
          device=None) -> List[SweepResult]:
    """Run the full (fabric × wafer shape × wafer count × strategy)
    cross-product.

    ``workload_fn`` builds the workload for a candidate strategy (the
    minibatch scales with DP, so the workload is strategy-dependent).
    One memo dict spans the whole sweep — collective times are keyed by
    the fabric's physical identity (Simulator._fabric_tag), so strategies
    sharing a collective on the same wafer hit the cache while distinct
    fabrics/shapes never collide.  Pareto flags are set per fabric on
    (time_per_sample, param_bytes_per_npu).

    ``n_npus`` is per wafer; ``max_wafers > 1`` adds clusters of 2..max
    wafers joined by ``inter_wafer_links × inter_wafer_bw`` links (see
    core/cluster.py), with DP replicas placed across wafers and
    wafer-split strategies tagged ``Strategy.wafers``.  ``max_wafers=1``
    (the default) is bit-identical to the single-wafer sweep.

    ``inter_topologies`` crosses every multi-wafer configuration with the
    listed inter-level collective models (ring / fully_connected /
    switch — core/cluster.py), and ``max_levels=2`` additionally sweeps
    the rack/pod stackings of each wafer count (:func:`hierarchy_specs`:
    4 wafers → flat (4,) and (2, 2)); every level shares the
    ``inter_wafer_*`` link budget.  The defaults (ring, 1 level) are
    bit-identical to the single-ring sweep, row for row.

    FRED routability (``check_routing=True``) is checked per (strategy,
    shape): the memo is keyed on both, and the actual (n_groups,
    group_size) shape is passed to :func:`repro_torch.core.routing
    .strategy_routable` — for clusters, the per-wafer sub-strategy is
    what must route on the wafer switch.  The router runs on the host.

    ``memory`` (a :class:`~repro_torch.core.workloads.MemoryModel`) turns on the
    per-NPU memory-feasibility objective: every result carries
    ``memory_bytes_per_npu`` and ``feasible``, and the Pareto front is
    computed on (time_per_sample, memory_bytes_per_npu) over *feasible*
    points only — an infeasible strategy is never flagged pareto.

    ``prune_symmetric`` dedupes candidate strategies by canonical
    simulation signature (:func:`sim_signature`) before simulating and
    replicates results onto the pruned twins, so the returned point set
    and Pareto front are identical to the unpruned sweep by construction
    (pinned at 20 NPUs in tests/test_autostrategy.py).

    ``engine`` selects the evaluator: ``"batched"`` (the default)
    evaluates all strategies of each (fabric, shape, wafer count) as
    float64 torch ops on ``device`` (``cuda`` unless given) via
    :class:`repro_torch.core.batch_engine.BatchEngine`
    — with the memory model vectorized alongside, so feasibility is
    masked in array math before any per-point Python runs — while
    ``"scalar"`` walks :meth:`Simulator.run` per point as the reference
    oracle.  Both produce bit-identical Breakdowns and Pareto fronts
    (enforced by hypothesis property tests in tests/test_batch_engine.py);
    batched is ≥10× faster on multi-wafer sweeps and is what makes
    exhaustive 500+-NPU sweeps fit the CI budget (BENCH_sweep.json).

    ``defects`` (a :class:`~repro_torch.core.defects.DefectMask`, applied to
    every wafer) evaluates the whole sweep under the mask: placement
    compacts onto healthy NPUs, mesh rings detour dead links, FRED spine
    bandwidth shrinks with severed uplinks, and candidates needing more
    healthy NPUs per wafer than the mask leaves are skipped.  Results
    carry ``defect_rate``/``defect_seed``/``degraded_time_s``; a None (or
    empty) mask is bit-identical to the defect-free sweep.

    ``ep_candidates``/``sp_candidates`` expand each enumerated strategy
    with expert- and sequence-parallel variants (see
    :func:`strategy_space`); the defaults (1,)/(1,) are bit-identical to
    the 5-axis sweep.  ``comm_overlap_fraction`` sets the Simulator's
    compute/communication overlap knob for every evaluated point (0.0,
    the default, is the fully-exposed model)."""
    if n_npus < 1:
        raise ValueError(f"n_npus must be ≥ 1, got {n_npus}")
    defects = normalize(defects)
    if defects is not None and defects.n_npus != n_npus:
        raise ValueError(
            f"defect mask covers {defects.n_npus} NPUs but the sweep's "
            f"wafer has {n_npus}")
    n_healthy = n_npus if defects is None else defects.n_healthy
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if not 1 <= max_levels <= 2:
        raise ValueError(f"max_levels must be 1 or 2 (wafer → rack → "
                         f"pod), got {max_levels}")
    # explicitly passed strategies always run: widen the wafer-count
    # enumeration to cover the largest split they ask for
    if strategies:
        max_wafers = max(max_wafers, max(st.wafers for st in strategies))
    # strategy space per wafer count (the utilization floor applies to the
    # cluster's total NPU count); strategy_space emits the wafer-split
    # variants, the per-shape capacity check happens in the loop below
    space: Dict[int, Sequence[Strategy]] = {}
    if strategies is None:
        for wf in range(1, max_wafers + 1):
            # under a defect mask the wafer only offers its healthy NPUs —
            # the utilization floor (and the enumeration ceiling) anchor
            # to the degraded capacity, so a 2%-dead wafer still sweeps
            # near-full strategies instead of returning nothing
            space[wf] = [st for st in
                         strategy_space(wf * n_healthy, n_layers=n_layers,
                                        min_utilization=min_utilization,
                                        n_wafers=wf,
                                        ep_candidates=ep_candidates,
                                        sp_candidates=sp_candidates)
                         if st.wafers == wf]
    results: List[SweepResult] = []
    cache = LRUCache(COLLECTIVE_CACHE_SIZE)
    route_memo: Dict[Tuple[Strategy, Tuple[int, int], int], bool] = {}
    inter_kw = dict(inter_wafer_links=inter_wafer_links,
                    inter_wafer_bw=inter_wafer_bw,
                    inter_wafer_latency=inter_wafer_latency)
    agg_inter_bw = inter_wafer_links * inter_wafer_bw

    # the valid candidate list, its symmetry-pruned representatives, the
    # packed parameter tensors, and the vectorized memory predicate are
    # all fabric/shape-independent — build them once per wafer count and
    # reuse across every (fabric, shape) below (workload_fn is assumed
    # pure: it was already called per (fabric, shape) with the same
    # strategy before this memo existed)
    per_wf: Dict[int, Tuple] = {}

    def _candidates(wf: int):
        ent = per_wf.get(wf)
        if ent is not None:
            return ent
        cands = ([st for st in strategies if st.wafers == wf]
                 if strategies is not None else space[wf])
        evals: List[Tuple[Strategy, Workload]] = []
        for st in cands:
            if st.n_workers > wf * n_npus or \
                    st.dp % st.wafers != 0 or \
                    st.mp * st.pp * (st.dp // st.wafers) > n_healthy:
                continue
            w = workload_fn(st)
            if st.pp > w.n_layers:        # stages must hold whole layers
                continue
            evals.append((st, w))
        # canonical-form dedup: one simulation per signature per
        # (fabric, shape, wafer count); twins replicate the breakdown
        if prune_symmetric:
            sig_index: Dict[Tuple, int] = {}
            rep_of: List[int] = []
            rep_idx: List[int] = []
            for i, (st, w) in enumerate(evals):
                sig = sim_signature(st, w)
                j = sig_index.get(sig)
                if j is None:
                    j = len(rep_idx)
                    sig_index[sig] = j
                    rep_idx.append(i)
                rep_of.append(j)
        else:
            rep_idx = list(range(len(evals)))
            rep_of = rep_idx
        rep_pack = mem_list = feas_list = None
        if engine == "batched":
            from .batch_engine import CandidateBatch, feasible_batch
            pack = CandidateBatch([w for _st, w in evals])
            rep_pack = (pack.take(rep_idx)
                        if len(rep_idx) != len(evals) else pack)
            if memory is not None:
                # vectorized feasibility — infeasible points are masked
                # on arrays before any per-point Python runs; bulk-
                # converted to Python scalars once per wafer count
                mem_arr, feas_arr = feasible_batch(pack, memory,
                                                   device=device)
                mem_list = mem_arr.tolist()
                feas_list = feas_arr.tolist()
        ent = (evals, rep_idx, rep_of, rep_pack, mem_list, feas_list)
        per_wf[wf] = ent
        return ent

    def _emit(fabric, wf, shape, hier, topo, sim, evals, rep_of, rep_brs,
              mem_list, feas_list):
        """One SweepResult row per candidate of this (fabric, shape,
        wafer count, hierarchy, inter topology) — shared by both engines
        so row order, Pareto and CSV output are engine-independent.
        Construction bypasses the dataclass __init__ — this loop runs
        once per sweep point and is the hottest shared Python in a
        500+-NPU sweep."""
        check_route = check_routing and fabric != "baseline"
        inter_bw = agg_inter_bw if wf > 1 else 0.0
        defect_rate = 0.0 if defects is None else defects.dead_npu_rate
        defect_seed = -1 if defects is None else defects.seed
        new = SweepResult.__new__
        for i, (st, w) in enumerate(evals):
            mem_bytes = 0.0
            feas: Optional[bool] = None
            if memory is not None:
                if mem_list is not None:
                    mem_bytes = mem_list[i]
                    feas = feas_list[i]
                else:
                    mem_bytes = memory_bytes_per_npu(w, memory)
                    feas = is_feasible(w, memory)
            routable = None
            if check_route:
                # uplink count depends on the FRED config, so it is
                # part of the memo key alongside (strategy, shape)
                up = sim.fred.uplinks_per_l1()
                key = (st, shape, up)
                if key not in route_memo:
                    from .routing import strategy_routable
                    sub = st if st.wafers == 1 else \
                        Strategy(st.mp, st.dp // st.wafers, st.pp)
                    route_memo[key] = strategy_routable(sub, shape,
                                                        uplinks=up,
                                                        defects=defects)
                routable = route_memo[key]
            br = rep_brs[rep_of[i]]
            r = new(SweepResult)
            r.__dict__ = {
                "fabric": fabric, "shape": shape, "strategy": st,
                "breakdown": br,
                "minibatch": w.minibatch,
                "param_bytes_per_npu": w.param_bytes_total /
                (st.mp * st.pp),
                "routable": routable, "pareto": False, "n_wafers": wf,
                "inter_wafer_bw": inter_bw,
                "memory_bytes_per_npu": mem_bytes, "feasible": feas,
                "hierarchy": hier, "inter_topology": topo,
                "defect_rate": defect_rate, "defect_seed": defect_seed,
                "degraded_time_s": (0.0 if defects is None
                                    else br.total)}
            results.append(r)

    for fabric in fabrics:
        shape_fn = mesh_shapes if fabric == "baseline" else fred_shapes
        configs = hierarchy_configs(n_npus, max_wafers, shape_fn,
                                    inter_topologies, max_levels)
        if defects is not None and fabric == "baseline":
            # a mesh shape whose healthy sub-mesh the mask disconnects
            # cannot host collectives at all — drop it (FRED trees stay
            # connected through the spine for any placeable mask)
            from .defects import mesh_connected
            configs = [c for c in configs
                       if mesh_connected(defects, c[1][0], c[1][1])]
        if engine == "batched":
            import numpy as np
            from .batch_engine import BatchEngine, CandidateBatch, InterLane
            # fuse configurations into as few vectorized runs as the
            # kernels allow: the wafer count, hierarchy spans and inter
            # topology are all per-lane inputs (InterLane), so every
            # (wafer count, hierarchy, topology) of a shape shares one
            # run; FRED shapes additionally fuse across shapes
            # (group_size is the only shape-dependent kernel input,
            # passed per lane)
            if fabric == "baseline":
                by_shape: Dict[Tuple[int, int], List] = {}
                for c in configs:
                    by_shape.setdefault(c[1], []).append(c)
                grp_list = list(by_shape.values())
            else:
                grp_list = [configs]
            brs_by_config: Dict[Tuple, list] = {}
            sim_by_config: Dict[Tuple, Simulator] = {}
            for grp in grp_list:
                max_wf = max(c[0] for c in grp)
                # one single-level cluster serves every fused lane: the
                # sweep's levels share one link budget, and the per-lane
                # InterLane carries each configuration's topology/spans
                sim = _simulator(fabric, grp[0][1], n_npus, cache,
                                 compute_efficiency, n_wafers=max_wf,
                                 defects=defects,
                                 comm_overlap_fraction=comm_overlap_fraction,
                                 **inter_kw)
                parts, gs_parts, il_parts, metas = [], [], [], []
                for wf, shape, hier, topo in grp:
                    _e, _ri, _ro, rep_pack, _m, _f2 = _candidates(wf)
                    parts.append(rep_pack)
                    metas.append(((wf, shape, hier, topo), len(rep_pack)))
                    il_parts.append(InterLane.for_config(
                        len(rep_pack), wf, hier if wf > 1 else (), topo))
                    if fabric != "baseline":
                        gs_parts.append(np.full(len(rep_pack), shape[1],
                                                dtype=np.int64))
                fused = CandidateBatch.concat(parts)
                gs_lane = np.concatenate(gs_parts) if gs_parts else None
                il_lane = (InterLane.concat(il_parts) if max_wf > 1
                           else None)
                brs = BatchEngine(sim, device=device).run_batch(
                    fused, gs_lane=gs_lane, inter_lane=il_lane)
                off = 0
                for key, nrep in metas:
                    brs_by_config[key] = brs[off:off + nrep]
                    sim_by_config[key] = sim
                    off += nrep
            # emit in the same configuration order as the scalar engine
            # so row order, Pareto and CSV are engine-independent
            for key in configs:
                wf, shape, hier, topo = key
                evals, _ri, rep_of, _rp, mem_arr, feas_arr = \
                    _candidates(wf)
                _emit(fabric, wf, shape, hier, topo, sim_by_config[key],
                      evals, rep_of, brs_by_config[key],
                      mem_arr, feas_arr)
        else:
            for wf, shape, hier, topo in configs:
                sim = _simulator(fabric, shape, n_npus, cache,
                                 compute_efficiency, n_wafers=wf,
                                 hierarchy=hier if wf > 1 else None,
                                 inter_topology=topo, defects=defects,
                                 comm_overlap_fraction=comm_overlap_fraction,
                                 **inter_kw)
                evals, rep_idx, rep_of, _rp, mem_arr, feas_arr = \
                    _candidates(wf)
                rep_brs = [sim.run(evals[i][1]) for i in rep_idx]
                _emit(fabric, wf, shape, hier, topo, sim, evals, rep_of,
                      rep_brs, mem_arr, feas_arr)
    # dict.fromkeys, not set(): first-seen order is deterministic across
    # processes, so the pareto flag assignment (and the CSV row order any
    # golden diff sees) cannot depend on PYTHONHASHSEED
    for fabric in dict.fromkeys(r.fabric for r in results):
        subset = [r for r in results if r.fabric == fabric]
        if memory is not None:
            # infeasible points never make the front; the memory objective
            # replaces the weight-only param_bytes proxy
            front = pareto_front([r for r in subset if r.feasible],
                                 keys=("time_per_sample",
                                       "memory_bytes_per_npu"))
        else:
            front = pareto_front(subset)
        for r in front:
            r.pareto = True
    return results


# --------------------------------------------------------------------------
# Pareto reporting
# --------------------------------------------------------------------------

def pareto_front(results: Sequence[SweepResult],
                 keys: Tuple[str, str] = ("time_per_sample",
                                          "param_bytes_per_npu")
                 ) -> List[SweepResult]:
    """Results not dominated on the (minimize, minimize) objective pair.

    Sort-based O(n log n) scan (cluster sweeps multiply point counts):
    sorted by the first key, a point survives iff its second key is the
    minimum within its first-key tie group AND strictly below every
    earlier group's minimum.  Exact duplicates don't dominate each other,
    so they all survive together; input order is preserved."""
    n = len(results)
    vals = list(map(operator.attrgetter(*keys), results))
    order = sorted(range(n), key=vals.__getitem__)
    keep = [False] * n
    best2 = float("inf")            # min 2nd key over strictly-lower groups
    i = 0
    while i < n:
        j = i
        while j < n and vals[order[j]][0] == vals[order[i]][0]:
            j += 1
        group = order[i:j]
        gmin = min(vals[idx][1] for idx in group)
        if gmin < best2:
            for idx in group:
                if vals[idx][1] == gmin:
                    keep[idx] = True
            best2 = gmin
        i = j
    return [r for r, k in zip(results, keep) if k]


CSV_HEADER = ("workload,fabric,shape_a,shape_b,n_wafers,n_npus,"
              "inter_wafer_bw,hierarchy,inter_topology,mp,dp,pp,ep,sp,"
              "minibatch,"
              "compute_s,input_load_s,mp_s,ep_s,dp_s,dp_intra_s,dp_inter_s,"
              "dp_level_1_s,dp_level_2_s,"
              "pp_s,stream_s,exposed_comm_s,total_s,"
              "time_per_sample_s,param_bytes_per_npu,"
              "memory_bytes_per_npu,feasible,routable,pareto,"
              "defect_rate,defect_seed,degraded_time_s")


def to_csv_rows(results: Sequence[SweepResult]) -> List[str]:
    """One row per sweep point; schema in benchmarks/README.md.  shape_a/b
    are rows/cols (baseline) or n_groups/group_size (FRED), per wafer;
    n_npus = shape_a·shape_b·n_wafers; hierarchy is the level stacking
    ("4" = flat, "2x2" = rack×pod) and dp_level_1_s/dp_level_2_s the raw
    per-inter-level DP time (0 where a level is absent)."""
    rows = []
    for r in results:
        br = r.breakdown
        lv = br.dp_levels + (0.0, 0.0)
        rows.append(
            f"{br.workload},{r.fabric},{r.shape[0]},{r.shape[1]},"
            f"{r.n_wafers},{r.n_npus},{r.inter_wafer_bw:.9g},"
            f"{'x'.join(map(str, r.hierarchy))},{r.inter_topology},"
            f"{r.strategy.mp},{r.strategy.dp},{r.strategy.pp},"
            f"{r.strategy.ep},{r.strategy.sp},"
            f"{r.minibatch},"
            f"{br.compute:.9g},{br.input_load:.9g},{br.mp:.9g},"
            f"{br.ep_s:.9g},"
            f"{br.dp:.9g},{br.dp_intra:.9g},{br.dp_inter:.9g},"
            f"{lv[0]:.9g},{lv[1]:.9g},"
            f"{br.pp:.9g},{br.stream:.9g},{br.exposed_comm_s:.9g},"
            f"{br.total:.9g},"
            f"{r.time_per_sample:.9g},{r.param_bytes_per_npu:.9g},"
            f"{r.memory_bytes_per_npu:.9g},"
            f"{'' if r.feasible is None else int(r.feasible)},"
            f"{'' if r.routable is None else int(r.routable)},"
            f"{int(r.pareto)},"
            f"{r.defect_rate:.9g},{r.defect_seed},"
            f"{r.degraded_time_s:.9g}")
    return rows


# --------------------------------------------------------------------------
# canonical workload templates
# --------------------------------------------------------------------------

def transformer_17b(strategy: Strategy) -> Workload:
    """Turing-NLG 17B (Table V) parameterized by strategy — the paper's
    Fig. 2 co-exploration subject."""
    return transformer("Transformer-17B", 78, 4256, 1024, strategy,
                       "stationary")


def transformer_17b_sweep(n_npus: int = 20, **kw) -> List[SweepResult]:
    """The headline sweep: Transformer-17B over every strategy and wafer
    shape at ``n_npus``."""
    return sweep(transformer_17b, n_npus, n_layers=78, **kw)
