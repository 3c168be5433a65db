"""Scale-out fabric levels: wafers stacked into a multi-level hierarchy
(ROADMAP "multi-wafer scale-out"; LIBRA-style multi-dimensional topology
optimization, Hecaton/Dragonfly-on-wafers-style scale-out variants).

The PyTorch port's own copy of ``repro.core.cluster``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

:class:`WaferCluster` wraps identical wafer fabrics — either the baseline
:class:`~repro_torch.core.meshnet.MeshFabric` or a
:class:`~repro_torch.core.fabric.FredFabric` — joined by a stack of
:class:`HierarchyLevel` s (wafer → rack → pod):

  * level 1 joins ``count`` wafers into a rack,
  * level 2 joins ``count`` racks into a pod, …

each with its own :class:`WaferLink` budget and an **inter-level topology**
``topology ∈ {ring, fully_connected, switch}`` selecting the collective
model for that level:

  * ``ring``            — endpoint ring over the level's aggregate links:
                          2(n−1) steps of 2(n−1)/n·D endpoint traffic for
                          All-Reduce (the single-ring model, bit-identical);
  * ``fully_connected`` — single-hop direct exchange (Dragonfly-style
                          all-to-all wiring): the same endpoint traffic
                          leaves each node, but split across n−1 parallel
                          peer links, so only 2 latency steps are paid;
  * ``switch``          — an in-switch reduction stage between the units,
                          reusing the FRED R/D µswitch semantics of
                          ``core/switch.py`` (reduce on the way in,
                          distribute on the way out, paper Sec. IV/V):
                          All-Reduce traffic drops to D per node — the
                          paper's ≈2× claim vs the 2(n−1)/n·D ring.

The wafer is the manufacturing unit, so scale-out *adds* NPUs: a 2×2
(rack×pod) cluster of 5×4 wafers has 80 NPUs.

Collectives that span wafers run the classic hierarchical decomposition:

  1. Reduce-Scatter among the group members *within* each wafer;
  2. per inter level, innermost first: Reduce-Scatter across the level's
     spanned units — or All-Reduce at the outermost spanned level;
  3. All-Gather back down (per level, then within each wafer).

``collective_time_levels`` returns the (intra-wafer, per-level) split so
the simulator can report ``dp_levels``; a single ring level reproduces
the single-ring ``(intra, inter)`` model bit-for-bit, and groups contained in one
wafer delegate straight to the wafer fabric.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .fabric import FredFabric
from .flows import endpoint_traffic_bytes, innetwork_traffic_bytes
from .meshnet import MeshFabric

WaferFabric = Union[MeshFabric, FredFabric]

#: valid inter-level topologies, in deterministic sweep order
INTER_TOPOLOGIES = ("ring", "fully_connected", "switch")

#: integer codes shared with the batched engine's per-lane topology arrays
TOPOLOGY_CODES = {t: i for i, t in enumerate(INTER_TOPOLOGIES)}

#: default names of the stacked levels (level 1 joins wafers into a rack…)
LEVEL_NAMES = ("rack", "pod", "row", "hall")


@dataclasses.dataclass(frozen=True)
class WaferLink:
    """Inter-level interconnect budget, per unit (Dojo-style wafer-edge
    bridges: many moderate links rather than one fat pipe — Dojo training
    tiles publish 9 TB/s per edge, 36 TB/s aggregate; the default 32×400
    GB/s = 12.8 TB/s sits inside that envelope)."""
    n_links: int = 32
    link_bw: float = 400e9            # B/s per link per direction
    latency: float = 5e-7             # repro: unit[s] (per inter-level step)

    def __post_init__(self):
        if self.n_links < 1 or self.link_bw <= 0:
            raise ValueError(f"wafer link needs ≥1 link of positive BW, "
                             f"got {self.n_links}×{self.link_bw}")

    @property
    def agg_bw(self) -> float:
        """Aggregate inter-level bandwidth per unit, one direction."""
        return self.n_links * self.link_bw


@dataclasses.dataclass(frozen=True)
class HierarchyLevel:
    """One inter level of the scale-out hierarchy: ``count`` units of the
    level below joined by ``link`` under ``topology``."""
    name: str
    count: int
    topology: str = "ring"
    link: WaferLink = dataclasses.field(default_factory=WaferLink)

    def __post_init__(self):
        if self.count < 1:
            raise ValueError(f"level {self.name!r} needs count ≥ 1, "
                             f"got {self.count}")
        if self.topology not in INTER_TOPOLOGIES:
            raise ValueError(
                f"level {self.name!r}: unknown topology "
                f"{self.topology!r}; expected one of {INTER_TOPOLOGIES}")


def level_collective_time(topology: str, kind: str, n: int, nbytes: float,
                          agg_bw: float, latency: float,
                          concurrent_groups: int = 1) -> float:
    """Time of one collective across ``n`` units of an inter level.

    ``agg_bw`` is the per-unit aggregate link bandwidth, shared by
    ``concurrent_groups`` groups crossing the level at once.  The ring
    branch is op-for-op the single-ring inter-wafer model (bit-identical);
    ``fully_connected`` splits the same aggregate across n−1 direct peer
    links (2 latency steps instead of 2(n−1)); ``switch`` reduces
    in-network (R µswitches in, D µswitches out — Sec. IV), so an
    All-Reduce injects D instead of 2(n−1)/n·D per unit."""
    if n <= 1 or nbytes <= 0:
        return 0.0
    bw = agg_bw / max(concurrent_groups, 1)
    if topology == "ring":
        traffic = endpoint_traffic_bytes(kind, n, nbytes)
        steps = 2 * (n - 1) if kind == "all_reduce" else (n - 1)
        return steps * ((traffic / steps) / bw + latency)
    if topology == "fully_connected":
        # direct exchange: each unit moves its D/n shard to every peer in
        # parallel over n−1 links of bw/(n−1) each — same endpoint bytes
        # as the ring, 2 latency steps (RS phase + AG phase) instead of
        # 2(n−1)
        shard = nbytes / n
        per_link_bw = bw / (n - 1)
        steps = 2 if kind == "all_reduce" else 1
        return steps * (shard / per_link_bw + latency)
    if topology == "switch":
        # in-switch reduction/distribution (core/switch.py semantics):
        # one traversal up (reduce), one down (broadcast)
        traffic = innetwork_traffic_bytes(kind, n, nbytes)
        steps = 2 if kind == "all_reduce" else 1
        return steps * ((traffic / steps) / bw + latency)
    raise ValueError(f"unknown inter-level topology {topology!r}; "
                     f"expected one of {INTER_TOPOLOGIES}")


def hierarchy_spans(n_wafers_spanned: int,
                    counts: Sequence[int]) -> List[int]:
    """Units spanned at each level by ``n_wafers_spanned`` consecutive
    wafers under the level ``counts`` — the closed form of
    :meth:`WaferCluster.spans_for` (the sweep and the batched engine
    broadcast these per configuration without building a cluster)."""
    rem = max(n_wafers_spanned, 1)
    spans: List[int] = []
    for c in counts:
        spans.append(min(rem, c))
        rem = -(-rem // c)
    return spans


def inter_traffic_bytes(topology: str, n: int, nbytes: float,
                        kind: str = "all_reduce") -> float:
    """Per-unit bytes injected onto an inter level's links.  Ring and
    fully-connected are endpoint algorithms (All-Reduce: 2(n−1)/n·D);
    the switch reduces in-network, dropping that to D — the ≈2× claim."""
    if topology in ("ring", "fully_connected"):
        return endpoint_traffic_bytes(kind, n, nbytes)
    if topology == "switch":
        return innetwork_traffic_bytes(kind, n, nbytes)
    raise ValueError(f"unknown inter-level topology {topology!r}; "
                     f"expected one of {INTER_TOPOLOGIES}")


@dataclasses.dataclass
class WaferCluster:
    """Identical wafers + the stacked inter levels.

    Backwards-compatible constructor: ``WaferCluster(wafer, n_wafers,
    link, topology)`` builds the single-level hierarchy (the single-ring model;
    ``topology="ring"`` is bit-identical to it).  Pass ``levels`` for
    rack/pod stacks — ``n_wafers`` must then equal the product of the
    level counts (or be left at 1 to be derived)."""
    wafer: WaferFabric
    n_wafers: int = 1
    link: WaferLink = dataclasses.field(default_factory=WaferLink)
    topology: str = "ring"
    levels: Optional[Sequence[HierarchyLevel]] = None
    # one DefectMask (or None = pristine) per wafer — the cluster stops
    # pretending every wafer shipped with the same holes.  Mutually
    # exclusive with a mask on the base ``wafer`` fabric; None keeps the
    # uniform-wafer fast path bit-identical.
    wafer_defects: Optional[Sequence] = None

    def __post_init__(self):
        if self.levels is not None:
            self.levels = tuple(self.levels)
            prod = 1
            for lvl in self.levels:
                prod *= lvl.count
            if self.n_wafers == 1:
                self.n_wafers = prod
            elif self.n_wafers != prod:
                raise ValueError(
                    f"n_wafers={self.n_wafers} inconsistent with level "
                    f"counts {tuple(l.count for l in self.levels)} "
                    f"(product {prod})")
        else:
            self.levels = (HierarchyLevel(LEVEL_NAMES[0], self.n_wafers,
                                          self.topology, self.link),)
        if self.n_wafers < 1:
            raise ValueError(f"cluster needs ≥ 1 wafer, got {self.n_wafers}")
        # wafer.n_npus is a property chain hit on every id translation —
        # hot enough to show in sweep profiles, so snapshot it once (the
        # wafer shape is fixed for the cluster's lifetime)
        self._npus_per_wafer = self.wafer.n_npus
        self._wafer_variants: Optional[Tuple[WaferFabric, ...]] = None
        if self.wafer_defects is not None:
            from .defects import normalize
            masks = tuple(normalize(m) for m in self.wafer_defects)
            if all(m is None for m in masks):
                self.wafer_defects = None
            else:
                if len(masks) != self.n_wafers:
                    raise ValueError(
                        f"wafer_defects has {len(masks)} entries for a "
                        f"{self.n_wafers}-wafer cluster — one mask (or "
                        f"None) per wafer")
                if self.wafer.defects is not None:
                    raise ValueError(
                        "per-wafer wafer_defects and a defect mask on the "
                        "base wafer fabric are mutually exclusive — pass "
                        "one or the other")
                for w, m in enumerate(masks):
                    if m is not None and m.n_npus != self._npus_per_wafer:
                        raise ValueError(
                            f"wafer {w} mask covers {m.n_npus} NPUs but "
                            f"each wafer has {self._npus_per_wafer}")
                self.wafer_defects = masks
                self._wafer_variants = tuple(
                    self.wafer if m is None
                    else dataclasses.replace(self.wafer, defects=m)
                    for m in masks)

    def wafer_fabric(self, wafer_idx: int) -> WaferFabric:
        """The fabric of one specific wafer — the base fabric unless a
        per-wafer defect mask replaces it with a degraded variant."""
        if self._wafer_variants is None:
            return self.wafer
        return self._wafer_variants[wafer_idx]

    @property
    def n_healthy_npus(self) -> int:
        """Usable NPUs across the cluster under the per-wafer masks (the
        base fabric's own mask counts uniformly when no per-wafer list is
        set)."""
        if self.wafer_defects is not None:
            npw = self._npus_per_wafer
            return sum(npw if m is None else m.n_healthy
                       for m in self.wafer_defects)
        return self.wafer.n_healthy * self.n_wafers

    # ---- id space --------------------------------------------------------------
    @property
    def npus_per_wafer(self) -> int:
        return self._npus_per_wafer

    @property
    def n_npus(self) -> int:
        return self.n_wafers * self.npus_per_wafer

    @property
    def hierarchy(self) -> Tuple[int, ...]:
        """Level counts, innermost first — e.g. (2, 2) for 2 wafers/rack
        × 2 racks/pod."""
        return tuple(lvl.count for lvl in self.levels)

    def wafer_of(self, gid: int) -> int:
        return gid // self.npus_per_wafer

    def local_id(self, gid: int) -> int:
        return gid % self.npus_per_wafer

    def split_by_wafer(self, group: Sequence[int]) -> Dict[int, List[int]]:
        """wafer idx → local NPU ids of the group members on that wafer."""
        by: Dict[int, List[int]] = {}
        for gid in group:
            by.setdefault(self.wafer_of(gid), []).append(self.local_id(gid))
        return by

    # ---- hierarchy geometry ----------------------------------------------------
    def level_spans(self, wafer_idxs: Iterable[int]) -> List[int]:
        """Units spanned at each level by a set of wafer indices (widest
        parent at each level — wafers are numbered rack-major, so DP
        groups placed by ``cluster_placement`` fill the innermost level
        before spilling to the next)."""
        idxs = set(wafer_idxs)
        spans: List[int] = []
        for lvl in self.levels:
            by_parent: Dict[int, int] = {}
            for i in idxs:
                by_parent[i // lvl.count] = by_parent.get(i // lvl.count,
                                                          0) + 1
            spans.append(max(by_parent.values()) if by_parent else 1)
            idxs = set(by_parent)
        return spans

    def spans_for(self, n_wafers_spanned: int) -> List[int]:
        """``level_spans`` of ``n_wafers_spanned`` *consecutive* wafers —
        what a cross-wafer DP group placed by ``cluster_placement``
        occupies.  The batched engine broadcasts these per configuration."""
        return self.level_spans(range(max(n_wafers_spanned, 1)))

    # ---- collectives -----------------------------------------------------------
    def _wafer_coll(self, kind: str, local_group: Sequence[int],
                    nbytes: float, concurrent_groups: int,
                    ring_family: "Tuple[int, int, int] | None" = None,
                    wafer_idx: int = 0) -> float:
        """Intra-wafer collective on wafer ``wafer_idx``'s fabric (the
        per-wafer degraded variant when ``wafer_defects`` is set).
        ``ring_family`` is the compact ``(count, stride, n_used)``
        descriptor of the strided concurrent local-group family (one per
        wafer); under a defect mask the mesh materializes it so detoured
        sibling rings charge the evaluated ring the real shared-link
        bandwidth (healthy meshes keep the single-ring model — their X-Y
        rings are disjoint)."""
        fab = self.wafer_fabric(wafer_idx)
        if isinstance(fab, MeshFabric):
            rings: Sequence[Sequence[int]] = ()
            if ring_family is not None and fab.defects is not None:
                from .meshnet import strided_ring_family
                rings = strided_ring_family(fab.defects.healthy(),
                                            *ring_family)
            return fab.collective_time(kind, local_group, nbytes,
                                       concurrent_rings=rings)
        return fab.collective_time(kind, local_group, nbytes,
                                   concurrent_groups=concurrent_groups)

    def inter_ring_params(self) -> Tuple[float, float]:
        """(aggregate level-1 BW, per-step latency) — kept for the single-ring
        API; :meth:`level_params` generalizes to deeper levels."""
        return self.levels[0].link.agg_bw, self.levels[0].link.latency

    def level_params(self, i: int) -> Tuple[float, float]:
        """(aggregate BW, per-step latency) of inter level ``i`` — what
        the batched engine reads once per run.  Levels past the stack
        reuse the outermost level's link (uniform-link sweeps fuse 1- and
        2-level configurations under one cluster object)."""
        lvl = self.levels[min(i, len(self.levels) - 1)]
        return lvl.link.agg_bw, lvl.link.latency

    def inter_allreduce_time(self, n_wafers_spanned: int, nbytes: float,
                             concurrent_groups: int = 1) -> float:
        """All-Reduce across ``n_wafers_spanned`` units of level 1 under
        that level's topology (ring: 2(w−1) steps over the aggregate
        links, shared by groups crossing concurrently — the single-ring model)."""
        lvl = self.levels[0]
        return level_collective_time(lvl.topology, "all_reduce",
                                     n_wafers_spanned, nbytes,
                                     lvl.link.agg_bw, lvl.link.latency,
                                     concurrent_groups)

    def _level_times(self, spans: Sequence[int], nbytes: float,
                     concurrent_groups: int) -> Tuple[float, ...]:
        """Per-level collective time for the hierarchical decomposition:
        Reduce-Scatter + All-Gather at every spanned level below the
        outermost spanned one, All-Reduce at the outermost.  Each level
        is billed the full payload — the concurrent per-shard exchanges
        of the level below share the same links, so the boundary traffic
        does not shrink with the local fan-in (see
        ``collective_time_levels``)."""
        out: List[float] = []
        for i, (lvl, s) in enumerate(zip(self.levels, spans)):
            if s <= 1 or nbytes <= 0:
                out.append(0.0)
                continue
            bw, lat = lvl.link.agg_bw, lvl.link.latency
            if any(s2 > 1 for s2 in spans[i + 1:]):
                t = (level_collective_time(lvl.topology, "reduce_scatter",
                                           s, nbytes, bw, lat,
                                           concurrent_groups) +
                     level_collective_time(lvl.topology, "all_gather",
                                           s, nbytes, bw, lat,
                                           concurrent_groups))
            else:
                t = level_collective_time(lvl.topology, "all_reduce",
                                          s, nbytes, bw, lat,
                                          concurrent_groups)
            out.append(t)
        return tuple(out)

    def collective_time_levels(self, kind: str, group: Sequence[int],
                               nbytes: float, concurrent_groups: int = 1,
                               inter_concurrent_groups: "int | None" = None,
                               ring_family: "Tuple[int, int, int] | None" = None
                               ) -> Tuple[float, Tuple[float, ...]]:
        """(intra-wafer, per-inter-level) time split for one collective.

        Wafers run their intra phases in parallel, so the intra part is
        the widest wafer's Reduce-Scatter + All-Gather; only All-Reduce
        is supported across wafers (MP/PP groups are placed within one
        wafer by ``cluster_placement``).  ``inter_concurrent_groups``
        lets the caller model a different contention level on the inter
        links than inside the wafer (GPipe staggers the DP exchanges of
        distinct pipeline stages, so only same-stage groups contend on
        the inter links while the wafer-internal fabric is shared by all
        of them); defaults to ``concurrent_groups``."""
        zeros = (0.0,) * len(self.levels)
        if len(group) <= 1 or nbytes <= 0:
            return 0.0, zeros
        by_wafer = self.split_by_wafer(group)
        if len(by_wafer) == 1:
            w = next(iter(by_wafer))
            return (self._wafer_coll(kind, by_wafer[w], nbytes,
                                     concurrent_groups,
                                     ring_family=ring_family, wafer_idx=w),
                    zeros)
        inter_conc = (concurrent_groups if inter_concurrent_groups is None
                      else inter_concurrent_groups)
        if kind == "all_to_all":
            # no reduction involved, so no RS/AG sandwich: each member
            # exchanges the wafer-local k/n share of its payload inside
            # the wafer, and the full payload crosses each spanned level
            # (same full-payload-per-level convention as ``_level_times``)
            n = len(group)
            intra = 0.0
            if self._wafer_variants is not None:
                # per-wafer masks: each wafer runs its local exchange on
                # its *own* degraded fabric in parallel — slowest gates
                for w, local in by_wafer.items():
                    kw = len(local)
                    if kw > 1:
                        intra = max(intra, self._wafer_coll(
                            "all_to_all", local, nbytes * kw / n,
                            concurrent_groups, ring_family=ring_family,
                            wafer_idx=w))
            else:
                widest = max(by_wafer.values(), key=len)
                k = len(widest)
                if k > 1:
                    intra = self._wafer_coll("all_to_all", widest,
                                             nbytes * k / n,
                                             concurrent_groups,
                                             ring_family=ring_family)
            spans = self.level_spans(by_wafer.keys())
            levels_t = tuple(
                level_collective_time(lvl.topology, "all_to_all", s, nbytes,
                                      lvl.link.agg_bw, lvl.link.latency,
                                      inter_conc) if s > 1 else 0.0
                for lvl, s in zip(self.levels, spans))
            return intra, levels_t
        if kind != "all_reduce":
            raise NotImplementedError(
                f"cross-wafer {kind!r} not modeled: placement keeps MP/PP "
                f"within a wafer, only the DP All-Reduce and the expert "
                f"All-to-All span wafers")
        if self._wafer_variants is not None:
            # per-wafer masks: the RS/AG sandwich runs concurrently on
            # every spanned wafer's own degraded fabric; the slowest
            # wafer's sandwich gates the hierarchical All-Reduce
            intra = 0.0
            for w, local in by_wafer.items():
                if len(local) <= 1:
                    continue
                t = (self._wafer_coll("reduce_scatter", local, nbytes,
                                      concurrent_groups,
                                      ring_family=ring_family, wafer_idx=w) +
                     self._wafer_coll("all_gather", local, nbytes,
                                      concurrent_groups,
                                      ring_family=ring_family, wafer_idx=w))
                intra = max(intra, t)
            spans = self.level_spans(by_wafer.keys())
            return intra, self._level_times(spans, nbytes, inter_conc)
        widest = max(by_wafer.values(), key=len)
        k = len(widest)
        intra = 0.0
        if k > 1:
            intra += self._wafer_coll("reduce_scatter", widest, nbytes,
                                      concurrent_groups,
                                      ring_family=ring_family)
        # the k per-member shard exchanges run concurrently but share the
        # same inter links at every level, so the group's boundary traffic
        # at a level is set by its full payload regardless of k (the
        # reduce-scatter avoids the k× redundancy a flat per-member
        # All-Reduce would push across, it does not shrink the cut bytes)
        spans = self.level_spans(by_wafer.keys())
        levels_t = self._level_times(spans, nbytes, inter_conc)
        if k > 1:
            intra += self._wafer_coll("all_gather", widest, nbytes,
                                      concurrent_groups,
                                      ring_family=ring_family)
        return intra, levels_t

    def collective_time_parts(self, kind: str, group: Sequence[int],
                              nbytes: float, concurrent_groups: int = 1,
                              inter_concurrent_groups: "int | None" = None,
                              ring_family: "Tuple[int, int, int] | None" = None
                              ) -> Tuple[float, float]:
        """(intra-wafer, total-inter) split — the two-way view of
        :meth:`collective_time_levels` (single-level clusters are
        bit-identical; deeper stacks sum their levels)."""
        intra, levels_t = self.collective_time_levels(
            kind, group, nbytes, concurrent_groups, inter_concurrent_groups,
            ring_family=ring_family)
        inter = 0.0
        for t in levels_t:
            inter += t
        return intra, inter

    def collective_time(self, kind: str, group: Sequence[int], nbytes: float,
                        concurrent_groups: int = 1) -> float:
        intra, inter = self.collective_time_parts(kind, group, nbytes,
                                                  concurrent_groups)
        return intra + inter

    # ---- PP / I/O (both stay within a wafer) -----------------------------------
    def pp_transfer_time(self, nbytes: float) -> float:
        return self.wafer.pp_transfer_time(nbytes)

    def wafer_io_rate(self) -> float:
        """Per-wafer sustainable I/O streaming rate — each wafer has its
        own I/O controllers and streams its replicas' weights locally."""
        return self.wafer.io_stream_rate()

    # ---- accounting ------------------------------------------------------------
    def inter_switch_hw(self) -> List[Dict[str, float]]:
        """HW accounting of the in-network reduction switches (one
        ``FredSwitch`` with as many ports as units joined, per ``switch``
        level) — Table-III-style area/power via ``core.switch``; empty
        when no level uses the switch topology."""
        from .switch import FredSwitch, hw_overhead
        out = []
        for lvl in self.levels:
            if lvl.topology == "switch" and lvl.count >= 2:
                o = hw_overhead(FredSwitch.build(lvl.count, 3))
                o["level"] = lvl.name
                out.append(o)
        return out

    def tag(self) -> Tuple:
        """Physical identity of the inter levels for collective memo keys
        (the wafer fabric contributes its own tag; per-wafer defect masks
        are part of the identity — two clusters with different hole
        patterns must never share collective memo entries)."""
        t = ("cluster", self.n_wafers) + tuple(
            (lvl.count, lvl.topology, lvl.link.n_links, lvl.link.link_bw,
             lvl.link.latency) for lvl in self.levels)
        if self.wafer_defects is not None:
            t = t + (tuple(self.wafer_defects),)
        return t
