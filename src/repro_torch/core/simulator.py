"""End-to-end training-time simulator (ASTRA-SIM-style, paper Sec. VII).

The PyTorch port's own copy of ``repro.core.simulator``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

Models one training iteration of a 3D-parallel workload on either the
baseline 2D-mesh or a FRED fabric:

  * compute: per-layer FLOPs / (peak·efficiency), MP-sharded;
  * MP comm: blocking All-Reduces per layer (forward and backward);
  * EP comm (MoE workloads with ``Strategy.ep > 1``): expert dispatch +
    combine All-to-All within each ep-sized DP subgroup, replacing one of
    the per-layer MP All-Reduces (the FFN one the dispatch subsumes); a
    ``comm_overlap_fraction`` share of the compute can hide EP then MP
    time, with the remainder reported as ``exposed_comm_s``;
  * PP: GPipe microbatching — bubble factor (M + S − 1)/M plus boundary
    activation transfers;
  * DP comm: per-layer gradient All-Reduce issued as backward finishes,
    overlapped with remaining backward compute (water-filling); exposed
    remainder is reported;
  * weight streaming: layer weights stream in at the fabric's sustainable
    I/O rate (hotspot-limited on the mesh, line-rate on FRED) overlapped
    with compute; gradients stream out during backward; optimizer runs
    near storage (Sec. III-A);
  * input loading: minibatch activations via I/O, prefetchable except
    under weight streaming (I/O busy ⇒ exposed, Sec. VIII Transformer-1T).

Returned ``Breakdown`` mirrors Fig. 10's stacks: compute + exposed
input-load / MP / DP / PP / weight-stream times.

Multi-wafer clusters (``n_wafers > 1``, core/cluster.py): DP replicas map
across wafers (cluster_placement), MP/PP stay within a wafer; the DP
All-Reduce runs hierarchically — Reduce-Scatter within wafer → per-level
inter collectives → All-Gather within wafer — and the raw per-level times
are reported as ``dp_intra``/``dp_inter``/``dp_levels``.  The inter
levels are configurable: ``hierarchy`` stacks wafer → rack → pod counts
and ``inter_topology`` selects the per-level collective model (``ring`` |
``fully_connected`` | ``switch`` — see core/cluster.py).  ``n_wafers=1``
is bit-identical to the single-wafer model, and a single ``ring`` level
(the defaults) is bit-identical to the single-ring wafer↔wafer model.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

from .defects import DefectMask
from .fabric import FredFabric
from .meshnet import MeshFabric
from .placement import Strategy, cached_placement_groups
from .specs import ClusterSpec, FabricSpec
from .workloads import Workload, BYTES

# the paper's modelled NPU (Table II, FP16): an input of the simulated
# wafer-scale system, not a rate of the card this code runs on
NPU_PEAK_FLOPS = 1000e12      # FP16 (Table II)


class LRUCache(collections.OrderedDict):
    """Bounded dict for ``Simulator.collective_cache`` sharing.

    Long multi-wafer sweeps accumulate one entry per distinct
    (fabric tag, kind, group, bytes, concurrency) tuple; unbounded, a
    500+-NPU scalar sweep grows without limit.  Reads refresh recency,
    writes evict the least-recently-used entry past ``maxsize`` — drop-in
    for the plain dict the Simulator expects (``get`` + item assignment).
    """

    def __init__(self, maxsize: int = 1 << 17):
        super().__init__()
        if maxsize < 1:
            raise ValueError(f"maxsize must be ≥ 1, got {maxsize}")
        self.maxsize = maxsize

    def get(self, key, default=None):
        try:
            value = super().__getitem__(key)
        except KeyError:
            return default
        self.move_to_end(key)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)


@dataclasses.dataclass
class Breakdown:
    workload: str
    fabric: str
    compute: float        # repro: unit[s]
    input_load: float     # repro: unit[s]
    mp: float             # repro: unit[s]
    dp: float             # repro: unit[s]
    pp: float             # repro: unit[s]
    stream: float         # repro: unit[s]
    # per-level DP split (informational): raw un-overlapped All-Reduce time
    # spent within wafers vs across the inter-level links.  ``dp`` remains
    # the *exposed* DP time and is what ``total`` counts; on a single wafer
    # dp_intra is the raw AR sum and dp_inter is 0.  ``dp_levels`` splits
    # dp_inter per hierarchy level (wafer↔wafer/rack, rack↔rack/pod, …);
    # empty on a single wafer, one entry per inter level on a cluster.
    dp_intra: float = 0.0             # repro: unit[s]
    dp_inter: float = 0.0             # repro: unit[s]
    dp_levels: Tuple[float, ...] = () # repro: unit[s]
    # exposed expert-parallel All-to-All time (0 unless Strategy.ep > 1 on
    # an MoE workload); counted by ``total``
    ep_s: float = 0.0                 # repro: unit[s]
    # blocking comm left after compute/comm overlap: post-overlap mp + ep_s
    # (informational — ``mp`` and ``ep_s`` already hold the reduced values)
    exposed_comm_s: float = 0.0       # repro: unit[s]

    @property
    def total(self) -> float:
        return (self.compute + self.input_load + self.mp + self.dp +
                self.pp + self.stream + self.ep_s)

    def as_dict(self) -> Dict[str, float]:
        # float-valued only (callers reduce over values); the per-level
        # dp split lives in the ``dp_levels`` attribute, whose sum is
        # ``dp_inter``
        return {"compute": self.compute, "input_load": self.input_load,
                "mp": self.mp, "dp": self.dp, "pp": self.pp,
                "stream": self.stream, "dp_intra": self.dp_intra,
                "dp_inter": self.dp_inter, "ep_s": self.ep_s,
                "exposed_comm_s": self.exposed_comm_s, "total": self.total}


_LEGACY_FABRIC_KW = ("mesh_shape", "fred_shape", "n_io")
_LEGACY_CLUSTER_KW = ("n_wafers", "inter_wafer_links", "inter_wafer_bw",
                      "inter_wafer_latency", "inter_topology", "hierarchy")


@dataclasses.dataclass
class Simulator:
    fabric_name: str                       # "baseline" | "FRED-A".."FRED-D"
    compute_efficiency: float = 0.45
    overlap_dp: bool = True
    # fraction of the compute time available to hide blocking collectives
    # (EP first, then MP): exposed = max(0, comm − fraction·compute).
    # 0.0 (the default) keeps comm fully additive — bit-identical to the
    # pre-overlap model.
    comm_overlap_fraction: float = 0.0
    # ---- consolidated construction specs (core/specs.py) ----------------
    spec: Optional[FabricSpec] = None              # wafer shape/io/defects
    cluster_spec: Optional[ClusterSpec] = None     # inter-wafer scale-out
    collective_cache: Optional[dict] = None        # shared memo for sweeps
    # ---- DEPRECATED kwarg shims: each one, when passed, overrides the
    # matching spec field (with a DeprecationWarning).  After construction
    # the attributes hold the *resolved* values either way, so existing
    # readers keep working.
    mesh_shape: Optional[Tuple[int, int]] = None   # (rows, cols); None → 5×4
    fred_shape: Optional[Tuple[int, int]] = None   # (n_groups, group_size)
    n_io: Optional[int] = None                     # None → derived / paper 18
    n_wafers: Optional[int] = None                 # 1 ≡ single wafer
    inter_wafer_links: Optional[int] = None        # links per unit per level
    inter_wafer_bw: Optional[float] = None         # B/s per link per dir
    inter_wafer_latency: Optional[float] = None    # repro: unit[s] per step
    inter_topology: Optional[str] = None           # ring | fully_connected
                                                   # | switch (every level)
    hierarchy: Optional[Tuple[int, ...]] = None    # level counts, innermost
                                                   # first; None → (n_wafers,)

    def _resolve_specs(self):
        """Merge the deprecated kwargs into FabricSpec/ClusterSpec and
        write the resolved values back onto the legacy attributes."""
        legacy = {k: getattr(self, k)
                  for k in _LEGACY_FABRIC_KW + _LEGACY_CLUSTER_KW
                  if getattr(self, k) is not None}
        if legacy:
            warnings.warn(
                f"Simulator({', '.join(sorted(legacy))}=...) kwargs are "
                f"deprecated; pass spec=FabricSpec(...) / "
                f"cluster_spec=ClusterSpec(...) instead",
                DeprecationWarning, stacklevel=4)
        spec = self.spec if self.spec is not None else FabricSpec()
        fkw = {k: legacy[k] for k in _LEGACY_FABRIC_KW if k in legacy}
        if fkw:
            spec = dataclasses.replace(spec, **fkw)
        cs = (self.cluster_spec if self.cluster_spec is not None
              else ClusterSpec())
        ckw = {k: legacy[k] for k in _LEGACY_CLUSTER_KW if k in legacy}
        if ckw:
            cs = dataclasses.replace(cs, **ckw)
        self.spec, self.cluster_spec = spec, cs
        self.mesh_shape, self.fred_shape = spec.mesh_shape, spec.fred_shape
        self.n_io = spec.n_io
        self.defects: Optional[DefectMask] = spec.defects
        self.wafer_defects = cs.wafer_defects
        if self.wafer_defects is not None:
            if self.defects is not None:
                raise ValueError(
                    "FabricSpec.defects (one mask for every wafer) and "
                    "ClusterSpec.wafer_defects (one mask per wafer) are "
                    "mutually exclusive")
            if cs.n_wafers == 1:
                raise ValueError(
                    "wafer_defects needs a multi-wafer cluster — use "
                    "FabricSpec.defects for a single wafer")
        self.n_wafers = cs.n_wafers
        self.inter_wafer_links = cs.inter_wafer_links
        self.inter_wafer_bw = cs.inter_wafer_bw
        self.inter_wafer_latency = cs.inter_wafer_latency
        self.inter_topology = cs.inter_topology
        self.hierarchy = cs.hierarchy

    def __post_init__(self):
        self._resolve_specs()
        if self.fabric_name == "baseline":
            kw = {} if self.mesh_shape is None else \
                dict(rows=self.mesh_shape[0], cols=self.mesh_shape[1])
            if self.n_io is not None:
                kw["n_io"] = self.n_io
            if self.defects is not None:
                kw["defects"] = self.defects
            self.mesh: Optional[MeshFabric] = MeshFabric(**kw)
            self.fred: Optional[FredFabric] = None
        else:
            from .fabric import CONFIGS
            if self.fabric_name not in CONFIGS:
                raise ValueError(
                    f"unknown fabric {self.fabric_name!r}; expected "
                    f"'baseline' or one of {sorted(CONFIGS)}")
            kw = {} if self.fred_shape is None else \
                dict(n_groups=self.fred_shape[0],
                     group_size=self.fred_shape[1])
            if self.n_io is not None:
                kw["n_io"] = self.n_io
            if self.defects is not None:
                kw["defects"] = self.defects
            self.mesh = None
            self.fred = FredFabric(CONFIGS[self.fabric_name], **kw)
        self.cluster = None
        if self.hierarchy is not None:
            prod = 1
            for c in self.hierarchy:
                prod *= c
            if self.n_wafers == 1:
                self.n_wafers = prod
            elif self.n_wafers != prod:
                raise ValueError(
                    f"n_wafers={self.n_wafers} inconsistent with "
                    f"hierarchy={self.hierarchy} (product {prod})")
        if self.n_wafers < 1:
            raise ValueError(f"n_wafers must be ≥ 1, got {self.n_wafers}")
        if self.n_wafers > 1:
            from .cluster import (HierarchyLevel, LEVEL_NAMES, WaferCluster,
                                  WaferLink)
            base = self.mesh if self.mesh is not None else self.fred
            link = WaferLink(self.inter_wafer_links, self.inter_wafer_bw,
                             self.inter_wafer_latency)
            counts = (self.hierarchy if self.hierarchy is not None
                      else (self.n_wafers,))
            levels = tuple(
                HierarchyLevel(LEVEL_NAMES[min(i, len(LEVEL_NAMES) - 1)],
                               c, self.inter_topology, link)
                for i, c in enumerate(counts))
            self.cluster = WaferCluster(base, self.n_wafers, levels=levels,
                                        wafer_defects=self.wafer_defects)

    @property
    def n_npus(self) -> int:
        if self.cluster is not None:
            return self.cluster.n_npus
        return self.mesh.n if self.mesh is not None else self.fred.n_npus

    @property
    def n_healthy_npus(self) -> int:
        """Usable NPUs after the defect mask (mask applies per wafer)."""
        if self.wafer_defects is not None:
            return self.cluster.n_healthy_npus
        if self.defects is None:
            return self.n_npus
        per_wafer = self.defects.n_healthy
        return per_wafer * (self.n_wafers if self.cluster is not None else 1)

    # ---- fabric dispatch -------------------------------------------------------
    def _groups(self, strategy: Strategy):
        """NPU-id groups for ``strategy`` on this fabric — memoized per
        (strategy, n_wafers, npus_per_wafer): mesh row-major placement
        linearizes to the same ids as fred_placement, so the canonical
        cached groups serve every fabric type (treat them as read-only)."""
        if self.cluster is not None:
            return cached_placement_groups(strategy, self.n_wafers,
                                           self.cluster.npus_per_wafer,
                                           self.defects,
                                           wafer_defects=self.wafer_defects)
        if strategy.wafers > 1:
            raise ValueError(
                f"{strategy} spans {strategy.wafers} wafers but this "
                f"simulator models a single wafer (n_wafers=1)")
        return cached_placement_groups(strategy, 1, self.n_npus,
                                       self.defects)

    def _fabric_tag(self):
        """Physical identity of the fabric, so one collective_cache dict
        can be shared across Simulators of different fabrics/shapes."""
        if self.mesh is not None:
            tag = ("mesh", self.mesh.rows, self.mesh.cols, self.mesh.link_bw,
                   self.mesh.latency_per_hop, self.mesh.step_overhead)
        else:
            c, f = self.fred.config, self.fred
            tag = (c.name, f.n_groups, f.group_size, c.npu_l1_bw, c.l1_l2_bw,
                   c.in_network, c.switch_latency, c.step_overhead)
        if self.defects is not None:
            tag = tag + (self.defects,)
        if self.cluster is not None:
            return self.cluster.tag() + tag
        return tag

    def _coll_time_levels(self, kind: str, group, nbytes: float,
                          concurrent: int,
                          inter_concurrent: Optional[int] = None,
                          ring_family: Optional[Tuple[int, int, int]] = None
                          ) -> Tuple[float, Tuple[float, ...]]:
        """(intra-wafer, per-inter-level) time for one collective; the
        inter tuple is empty on a single wafer and all-zero for groups
        contained within one wafer of a cluster.

        ``ring_family`` is the compact ``(count, stride, n_used)``
        descriptor of the strided concurrent-group family ``group``
        belongs to (see :func:`~repro_torch.core.meshnet.strided_ring_family`).
        Under a defect mask the mesh path materializes the family so the
        evaluated ring pays the real shared-link bandwidth on detour
        paths; healthy meshes ignore it (disjoint X-Y rings)."""
        if self.collective_cache is not None:
            key = (self._fabric_tag(), kind, tuple(group), nbytes,
                   concurrent, inter_concurrent, ring_family)
            hit = self.collective_cache.get(key)
            if hit is not None:
                return hit
        if self.cluster is not None:
            parts = self.cluster.collective_time_levels(
                kind, group, nbytes, concurrent_groups=concurrent,
                inter_concurrent_groups=inter_concurrent,
                ring_family=ring_family)
        elif self.mesh is not None:
            rings: Tuple = ()
            if ring_family is not None and self.defects is not None:
                from .meshnet import strided_ring_family
                rings = strided_ring_family(self.defects.healthy(),
                                            *ring_family)
            parts = (self.mesh.collective_time(kind, group, nbytes,
                                               concurrent_rings=rings), ())
        else:
            parts = (self.fred.collective_time(kind, group, nbytes,
                                               concurrent_groups=concurrent),
                     ())
        if self.collective_cache is not None:
            self.collective_cache[key] = parts
        return parts

    def _coll_time(self, kind: str, group, nbytes: float, concurrent: int,
                   ring_family: Optional[Tuple[int, int, int]] = None
                   ) -> float:
        intra, levels = self._coll_time_levels(kind, group, nbytes,
                                               concurrent,
                                               ring_family=ring_family)
        t = intra
        for x in levels:
            t += x
        return t

    def _pp_time(self, nbytes: float) -> float:
        if self.cluster is not None:
            return self.cluster.pp_transfer_time(nbytes)
        if self.mesh is not None:
            return self.mesh.pp_transfer_time(nbytes)
        return self.fred.pp_transfer_time(nbytes)

    def _io_rate(self) -> float:
        """Per-wafer sustainable I/O rate (wafers stream independently)."""
        if self.cluster is not None:
            return self.cluster.wafer_io_rate()
        if self.mesh is not None:
            return self.mesh.io_stream_rate()
        return self.fred.io_stream_rate()

    # ---- main -------------------------------------------------------------------
    def run(self, w: Workload) -> Breakdown:
        st = w.strategy
        groups = self._groups(st)
        mp_group = groups["mp"][0]
        dp_group = groups["dp"][0]
        n_dp_groups = len(groups["dp"])
        if st.pp > w.n_layers:
            raise ValueError(
                f"{st} has pp={st.pp} stages but {w.name} only "
                f"{w.n_layers} layers — stages must hold whole layers")
        if st.ep > 1 and st.dp_per_wafer % st.ep != 0:
            raise ValueError(
                f"{st}: ep={st.ep} must divide the per-wafer DP degree "
                f"{st.dp_per_wafer} — EP groups stay within a wafer")
        if st.sp > 1 and st.mp % st.sp != 0:
            raise ValueError(
                f"{st}: sp={st.sp} must divide mp={st.mp} — sequence "
                f"parallelism splits activations across MP peers")
        # uneven division: the pipeline is paced by its largest stage, so
        # compute/MP/DP are modeled at ceil(n_layers / pp) layers per stage
        # (exact when pp divides n_layers)
        layers_per_stage = -(-w.n_layers // st.pp)
        samples_per_npu = w.samples_per_dp
        # NPUs used per wafer — the id range the strided concurrent-group
        # families of every parallelism axis tile (meshnet
        # strided_ring_family); descriptors ride to the mesh path so
        # masked collectives see their siblings' detour congestion
        n_used = st.mp * st.pp * st.dp_per_wafer

        # ---- compute ------------------------------------------------------------
        eff_flops = NPU_PEAK_FLOPS * self.compute_efficiency
        fwd_layer = (w.flops_fwd_per_sample_layer * samples_per_npu /
                     st.mp / eff_flops)
        bwd_layer = 2 * fwd_layer
        fwd_stage = fwd_layer * layers_per_stage
        bwd_stage = bwd_layer * layers_per_stage

        # GPipe microbatching (Sec. VII-C: 8 microbatches for T-17B; weight
        # streaming uses pp-many, which suffices to hide the tiny pipeline)
        microbatches = 8 if (st.pp > 1 and w.execution == "stationary") else \
            max(st.pp, 1)
        if st.pp > 1:
            bubble = (microbatches + st.pp - 1) / microbatches
        else:
            bubble = 1.0
        compute = (fwd_stage + bwd_stage) * bubble

        # ---- MP comm --------------------------------------------------------------
        # with EP active, the expert-dispatch All-to-All subsumes the FFN
        # All-Reduce — one fewer MP sync per layer per pass (Megatron/Tutel)
        ep_active = st.ep > 1 and w.a2a_bytes_per_sample_layer > 0.0
        mp_ar = w.mp_allreduce_per_layer
        if ep_active and mp_ar:
            mp_ar = mp_ar - 1
        mp_time = 0.0
        if st.mp > 1 and mp_ar:
            act_bytes = w.act_bytes_per_sample * samples_per_npu
            # MP groups contend within their own wafer only — the fabric-BW
            # share is the per-wafer group count (== total on one wafer)
            mp_conc = max(1, len(groups["mp"]) // st.wafers)
            per_layer = self._coll_time("all_reduce", mp_group, act_bytes,
                                        concurrent=mp_conc,
                                        ring_family=(st.mp, 1, n_used))
            # fwd + bwd, every layer of this stage, all microbatches pipelined
            mp_time = (per_layer * mp_ar * 2 *
                       layers_per_stage * bubble)

        # ---- EP comm (MoE expert dispatch/combine All-to-All) ----------------------
        ep_raw = 0.0
        if ep_active:
            # EP groups are ep consecutive DP peers of the same (mp, pp)
            # coordinate — the first ep members of the first DP group
            # (NPU-id stride mp·pp under the canonical placements, defect
            # remapping included), always within one wafer (ep | dp/wafer)
            ep_group = dp_group[:st.ep]
            ep_conc = max(1, st.mp * st.pp * st.dp // (st.ep * st.wafers))
            a2a_bytes = w.a2a_bytes_per_sample_layer * samples_per_npu
            per_layer = self._coll_time(
                "all_to_all", ep_group, a2a_bytes, concurrent=ep_conc,
                ring_family=(st.ep, st.mp * st.pp, n_used))
            # dispatch + combine (×2), fwd + bwd (×2), every layer, bubbled
            ep_raw = per_layer * 2 * 2 * layers_per_stage * bubble

        # ---- compute/comm overlap --------------------------------------------------
        # a comm_overlap_fraction share of the compute hides blocking
        # collectives: EP first (the dispatch sits right next to the expert
        # FLOPs it feeds), then MP with whatever budget remains
        overlappable = self.comm_overlap_fraction * compute
        ep_time = max(0.0, ep_raw - overlappable)
        rem = max(0.0, overlappable - ep_raw)
        mp_time = max(0.0, mp_time - rem)
        exposed_comm = mp_time + ep_time

        # ---- PP comm ---------------------------------------------------------------
        pp_time = 0.0
        if st.pp > 1:
            act_bytes = w.act_bytes_per_sample * samples_per_npu
            # fwd + bwd boundary transfer per microbatch, on the critical
            # path only for the bubble-exposed fraction; SP shards the
            # boundary tensor a further sp-way
            per_mb = 2 * self._pp_time(act_bytes / microbatches / st.sp)
            pp_time = per_mb * (microbatches + st.pp - 1)

        # ---- DP comm ----------------------------------------------------------------
        dp_time = 0.0
        dp_intra = dp_inter = 0.0
        n_inter_levels = (len(self.cluster.levels)
                          if self.cluster is not None else 0)
        lvl_acc = [0.0] * n_inter_levels
        grad_bytes_per_layer = w.params_per_layer * BYTES / st.mp
        if st.dp > 1 and w.execution == "stationary":
            # inside the wafer all mp·pp DP groups share the fabric, but on
            # the inter-level links only the mp groups of the same pipeline
            # stage contend — GPipe backward staggers the other stages.
            # One model evaluation; the per-layer accumulation stays a sum
            # (not a multiply) so totals match the seed bit-for-bit.
            ti, te_levels = self._coll_time_levels(
                "all_reduce", dp_group, grad_bytes_per_layer,
                concurrent=n_dp_groups, inter_concurrent=st.mp,
                ring_family=(st.dp_per_wafer, st.mp * st.pp, n_used))
            for _ in range(layers_per_stage):
                dp_intra += ti
                for i, te in enumerate(te_levels):
                    lvl_acc[i] += te
            for x in lvl_acc:
                dp_inter += x
            total_ar = dp_intra + dp_inter
            if self.overlap_dp:
                # layer-by-layer ARs overlap with remaining backward compute
                dp_time = max(0.0, total_ar - bwd_stage * (1 - 1 / max(layers_per_stage, 1)))
            else:
                dp_time = total_ar

        # ---- weight streaming ----------------------------------------------------------
        stream_time = 0.0
        input_load = 0.0
        if w.execution == "streaming":
            io_rate = self._io_rate()
            # model in (fwd) + model in again (bwd) + gradients out (bwd);
            # gradient reduction toward I/O happens in-fabric (reverse of
            # Fig. 4); all overlap with compute.  Every wafer streams the
            # same weights through its own I/O, so the time is per-wafer.
            stream_bytes = w.param_bytes_total * (2 + 1) / st.pp
            io_time = stream_bytes / io_rate
            exposed = max(0.0, io_time - compute - mp_time)
            stream_time = exposed
            # input minibatch cannot prefetch while weights stream (Sec
            # VIII); each wafer loads its own DP replicas' share in parallel
            in_bytes = w.minibatch * w.act_bytes_per_sample
            input_load = in_bytes / (io_rate * st.wafers)
        else:
            # input prefetched during previous iteration — not exposed
            input_load = 0.0

        return Breakdown(workload=w.name, fabric=self.fabric_name,
                         compute=compute, input_load=input_load,
                         mp=mp_time, dp=dp_time, pp=pp_time,
                         stream=stream_time, dp_intra=dp_intra,
                         dp_inter=dp_inter, dp_levels=tuple(lvl_acc),
                         ep_s=ep_time, exposed_comm_s=exposed_comm)


def compare(workload: Workload, fabrics=("baseline", "FRED-C", "FRED-D"),
            **kw) -> Dict[str, Breakdown]:
    return {f: Simulator(f, **kw).run(workload) for f in fabrics}


def speedup_table(**kw) -> Dict[str, Dict[str, float]]:
    """Fig. 10 headline: total-time speedup of FRED-C/D over baseline."""
    from .workloads import paper_workloads
    out = {}
    for w in paper_workloads():
        res = compare(w, **kw)
        base = res["baseline"].total
        out[w.name] = {f: base / br.total for f, br in res.items()}
    return out
