"""Device placement (paper Sec. V-C option 4 + baseline policy Sec. VII-C).

The PyTorch port's own copy of ``repro.core.placement``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

``fred_placement``: workers of the same MP group on consecutive NPUs, then
iterate PP, then DP — with FRED_3 switches this suffices to avoid routing
conflicts for 3D-parallelism (the property ``tests/test_routing.py``
verifies exhaustively for many (mp, dp, pp) shapes).

``mesh_placement``: the baseline's priority order MP > PP > DP mapped onto
the 2D mesh row-major (favoring MP adjacency, as in Megatron-LM [28]).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Optional, Tuple

from .defects import DefectMask

Worker = Tuple[int, int, int]          # (mp, dp, pp) coordinates


@dataclasses.dataclass(frozen=True)
class Strategy:
    mp: int
    dp: int
    pp: int
    wafers: int = 1        # wafer axis: DP replicas spread over this many
                           # wafers of a WaferCluster (1 = single wafer)
    ep: int = 1            # expert-parallel degree: experts shard over ep
                           # DP peers within a wafer; the dispatch/combine
                           # All-to-All runs inside each EP group
    sp: int = 1            # sequence-parallel degree: activations split
                           # along the sequence dim across sp of the mp
                           # peers (Megatron-SP style)

    @property
    def n_workers(self) -> int:
        return self.mp * self.dp * self.pp

    @property
    def dp_per_wafer(self) -> int:
        return self.dp // self.wafers

    def workers(self) -> Iterator[Worker]:
        for d in range(self.dp):
            for p in range(self.pp):
                for m in range(self.mp):
                    yield (m, d, p)

    def mp_groups(self) -> List[List[Worker]]:
        return [[(m, d, p) for m in range(self.mp)]
                for d in range(self.dp) for p in range(self.pp)]

    def dp_groups(self) -> List[List[Worker]]:
        return [[(m, d, p) for d in range(self.dp)]
                for m in range(self.mp) for p in range(self.pp)]

    def pp_groups(self) -> List[List[Worker]]:
        return [[(m, d, p) for p in range(self.pp)]
                for m in range(self.mp) for d in range(self.dp)]

    def ep_groups(self) -> List[List[Worker]]:
        """Blocks of ``ep`` consecutive DP peers per (mp, pp) coordinate —
        consecutive d share a wafer under :func:`cluster_placement` as long
        as ``ep`` divides ``dp_per_wafer`` (validated by the simulator)."""
        return [[(m, b * self.ep + e, p) for e in range(self.ep)]
                for m in range(self.mp) for p in range(self.pp)
                for b in range(self.dp // self.ep)]

    def __str__(self):
        s = f"MP({self.mp})-DP({self.dp})-PP({self.pp})"
        if self.wafers > 1:
            s += f"-W({self.wafers})"
        if self.ep > 1:
            s += f"-EP({self.ep})"
        if self.sp > 1:
            s += f"-SP({self.sp})"
        return s


def fred_placement(strategy: Strategy, n_npus: "int | None" = None
                   ) -> Dict[Worker, int]:
    """worker → physical NPU id; MP consecutive, then PP, then DP.

    ``n_npus`` (when given) validates the strategy against a generalized
    fabric capacity."""
    if n_npus is not None and strategy.n_workers > n_npus:
        raise ValueError(f"{strategy} needs {strategy.n_workers} NPUs, "
                         f"fabric has {n_npus}")
    placement: Dict[Worker, int] = {}
    nid = 0
    for d in range(strategy.dp):
        for p in range(strategy.pp):
            for m in range(strategy.mp):
                placement[(m, d, p)] = nid
                nid += 1
    return placement


def mesh_placement(strategy: Strategy, rows: int, cols: int
                   ) -> Dict[Worker, Tuple[int, int]]:
    """worker → (row, col); MP > PP > DP priority (baseline, Sec. VII-C)."""
    if strategy.n_workers > rows * cols:
        raise ValueError(f"{strategy} needs {strategy.n_workers} NPUs, "
                         f"{rows}x{cols} mesh has {rows * cols}")
    placement: Dict[Worker, Tuple[int, int]] = {}
    nid = 0
    for d in range(strategy.dp):
        for p in range(strategy.pp):
            for m in range(strategy.mp):
                placement[(m, d, p)] = divmod(nid, cols)
                nid += 1
    return placement


def cluster_placement(strategy: Strategy, n_wafers: int,
                      npus_per_wafer: int) -> Dict[Worker, int]:
    """worker → global NPU id on a :class:`~repro_torch.core.cluster.WaferCluster`.

    DP replicas are spread across wafers *first* (the DP gradient exchange
    is the cheapest traffic to push over the inter-wafer links: one
    hierarchical All-Reduce per layer, vs per-microbatch MP/PP activation
    traffic), and each model instance (its mp×pp workers) lives entirely
    within one wafer.  Within a wafer the ``fred_placement`` order — MP
    consecutive, then PP, then DP — is preserved, so ``strategy.wafers = 1``
    reproduces ``fred_placement`` exactly.

    Global ids are ``wafer_idx * npus_per_wafer + local_id``; wafers are
    numbered rack-major (wafer ``w`` sits in rack ``w // rack_size``), so
    a DP split maps across the *deepest* hierarchy levels progressively —
    it fills one rack before spilling into the next, and only
    wafer-counts beyond the rack size pay the pod-level exchange
    (``WaferCluster.level_spans``).
    """
    w = strategy.wafers
    if w < 1:
        raise ValueError(f"{strategy} has wafers={w}; need ≥ 1")
    if w > n_wafers:
        raise ValueError(f"{strategy} spans {w} wafers, cluster has "
                         f"{n_wafers}")
    if strategy.dp % w != 0:
        raise ValueError(f"{strategy}: dp={strategy.dp} not divisible by "
                         f"wafers={w} — DP replicas map whole onto wafers")
    per_wafer_workers = strategy.mp * strategy.pp * (strategy.dp // w)
    if per_wafer_workers > npus_per_wafer:
        raise ValueError(f"{strategy} needs {per_wafer_workers} NPUs per "
                         f"wafer, wafer has {npus_per_wafer}")
    dp_per_wafer = strategy.dp // w
    placement: Dict[Worker, int] = {}
    for d in range(strategy.dp):
        wafer, dl = divmod(d, dp_per_wafer)
        for p in range(strategy.pp):
            for m in range(strategy.mp):
                local = (dl * strategy.pp + p) * strategy.mp + m
                placement[(m, d, p)] = wafer * npus_per_wafer + local
    return placement


def placement_groups(strategy: Strategy, placement: Dict[Worker, int]
                     ) -> Dict[str, List[List[int]]]:
    """NPU-id groups per parallelism type under a placement."""
    as_ids = lambda groups: [[placement[w] for w in g] for g in groups]
    return {"mp": as_ids(strategy.mp_groups()),
            "dp": as_ids(strategy.dp_groups()),
            "pp": as_ids(strategy.pp_groups())}


def defect_placement(strategy: Strategy, mask: DefectMask,
                     npus_per_wafer: "int | None" = None) -> Dict[Worker, int]:
    """worker → physical NPU id, compacted around the mask's holes.

    Logical slot ``i`` of the canonical :func:`fred_placement` order lands
    on the ``i``-th *healthy* NPU (SpiNNaker2-style compaction): MP groups
    stay on consecutive healthy NPUs, the strategy's relative order is
    unchanged, and an all-healthy mask reproduces ``fred_placement``
    exactly.  Raises when the strategy needs more workers than the wafer
    has healthy NPUs."""
    npw = npus_per_wafer if npus_per_wafer is not None else mask.n_npus
    base = fred_placement(strategy, npw)
    healthy = mask.healthy()
    if strategy.n_workers > len(healthy):
        raise ValueError(
            f"{strategy} needs {strategy.n_workers} healthy NPUs, "
            f"defect mask leaves {len(healthy)}")
    return {w: healthy[nid] for w, nid in base.items()}


def _masked_wafer_capacity(strategy: Strategy, n_wafers: int,
                           mask: DefectMask) -> None:
    per_wafer = strategy.mp * strategy.pp * strategy.dp_per_wafer
    if per_wafer > mask.n_healthy:
        raise ValueError(
            f"{strategy} needs {per_wafer} healthy NPUs per wafer, "
            f"defect mask leaves {mask.n_healthy}")


@functools.lru_cache(maxsize=4096)
def cached_placement_groups(strategy: Strategy, n_wafers: int,
                            npus_per_wafer: int,
                            defects: Optional[DefectMask] = None,
                            wafer_defects: "Optional[Tuple[Optional[DefectMask], ...]]" = None
                            ) -> Dict[str, List[List[int]]]:
    """Memoized :func:`placement_groups` for the canonical placements.

    The NPU-id groups depend only on (strategy, n_wafers, npus_per_wafer):
    ``mesh_placement``'s row-major (row, col) linearizes back to the same
    ids ``fred_placement`` assigns, and ``cluster_placement`` is already
    id-based — so one memo entry serves every fabric type and shape with
    the same per-wafer capacity.  Sweeps re-run the same strategy across
    many (fabric, shape) pairs; this turns the dominant per-``run`` cost
    (rebuilding O(n_workers) group lists) into a dict hit.

    With a :class:`DefectMask` the canonical local ids are compacted onto
    each wafer's healthy NPUs (the same mask is applied to every wafer —
    the cost model's worst-wafer simplification), keeping MP groups on
    consecutive *healthy* NPUs.  ``wafer_defects`` (mutually exclusive
    with ``defects``) supplies one mask — or None for a pristine wafer —
    per cluster wafer instead, compacting each wafer onto its *own*
    healthy list; the strategy occupies wafers ``0..strategy.wafers-1``,
    so only those wafers' capacities gate it.

    Callers must treat the returned lists as immutable (they are shared).
    Capacity violations raise ``ValueError`` exactly like the uncached
    placements (exceptions are not cached by ``lru_cache``).
    """
    if defects is not None and wafer_defects is not None:
        raise ValueError("defects and wafer_defects are mutually "
                         "exclusive — pass one uniform mask or one mask "
                         "per wafer")
    if n_wafers > 1:
        ids = cluster_placement(strategy, n_wafers, npus_per_wafer)
    else:
        ids = fred_placement(strategy, npus_per_wafer)
    groups = placement_groups(strategy, ids)
    npw = npus_per_wafer
    if wafer_defects is not None:
        if len(wafer_defects) != n_wafers:
            raise ValueError(
                f"wafer_defects has {len(wafer_defects)} entries for "
                f"{n_wafers} wafers — one mask (or None) per wafer")
        per_wafer = strategy.mp * strategy.pp * strategy.dp_per_wafer
        healthy_by_wafer = [tuple(range(npw)) if m is None else m.healthy()
                            for m in wafer_defects]
        for w in range(strategy.wafers):
            if per_wafer > len(healthy_by_wafer[w]):
                raise ValueError(
                    f"{strategy} needs {per_wafer} healthy NPUs on wafer "
                    f"{w}, its defect mask leaves "
                    f"{len(healthy_by_wafer[w])}")

        def remap_pw(gid: int) -> int:
            wafer, local = divmod(gid, npw)
            return wafer * npw + healthy_by_wafer[wafer][local]

        return {k: [[remap_pw(i) for i in g] for g in gs]
                for k, gs in groups.items()}
    if defects is None:
        return groups
    _masked_wafer_capacity(strategy, n_wafers, defects)
    healthy = defects.healthy()

    def remap(gid: int) -> int:
        wafer, local = divmod(gid, npw)
        return wafer * npw + healthy[local]

    return {k: [[remap(i) for i in g] for g in gs]
            for k, gs in groups.items()}


def strided_group(count: int, stride: int) -> List[int]:
    """The NPU-id pattern every canonical first group reduces to.

    Under :func:`fred_placement` / :func:`mesh_placement` /
    :func:`cluster_placement` the simulator's representative groups are
    arithmetic progressions from 0: the first MP group is
    ``strided_group(mp, 1)`` and the first DP group (per wafer) is
    ``strided_group(dp_per_wafer, mp * pp)``.  The batched engine
    (core/batch_engine.py) keys its structural tables on (count, stride)
    instead of materializing whole placements."""
    return list(range(0, count * stride, stride))
