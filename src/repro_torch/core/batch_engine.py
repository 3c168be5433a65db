"""Batched evaluation of the analytical cost model on float64 torch tensors.

Counterpart of ``repro.core.batch_engine`` (NumPy).  The scalar reference
(:meth:`repro_torch.core.simulator.Simulator.run`) walks one strategy at a
time; this module evaluates *all* strategies of one (fabric, wafer shape,
wafer count) configuration at once, and its results are **bit-identical** to
the scalar engine's and to the NumPy engine's: the same IEEE-754 operations
in the same order (``tests/test_torch_core.py`` holds all three equal).

What runs where:

  * **host (NumPy, exact integers)** — the candidate pack
    (:class:`CandidateBatch`), the validation, every integer lane the float
    math reads (stage depth, microbatches, group counts and strides, masks)
    and the structure tables of the fabric models (a mesh ring's congestion
    and mean hops, a FRED group's L1 span), reckoned once per (topology,
    count, stride) pattern and memoized;
  * **device (torch ``float64`` / ``int64``)** — the float math of
    ``run_batch``, the collective formulas (``_mesh_coll``, ``_fred_coll``,
    ``_level_coll``), the iterated per-layer DP sum and the memory model.
    The lanes reach the device in two copies (one ``int64`` stack, one
    ``float64`` stack) and the results come back in one; ``Breakdown`` s are
    built from that host array, never by indexing a device tensor per
    candidate.

Where torch and NumPy round differently, and what this module does about it:

  1. an ``int64`` tensor meeting a Python float, and ``int64 / int64``, give
     ``float32`` in torch and ``float64`` in NumPy: every integer lane that
     meets a float is cast with ``.double()`` first (exact below 2**53);
  2. ``python_float / tensor`` is ``tensor.reciprocal() * python_float`` in
     torch, and on CUDA ``tensor / python_float`` multiplies by the
     reciprocal: every division by or of a constant goes through a 0-dim
     float64 tensor on the device (:meth:`BatchEngine._c`), so it is a true
     division;
  3. no fused operation (``addcmul``, ``lerp``, ``add(alpha=)``): one aten
     op per NumPy op, in the reference's order, so nothing is contracted
     into an FMA;
  4. the per-layer DP time is replayed as iterated adds
     (:func:`_iterated_layer_sum`), never a ``sum`` or a multiply;
  5. ``np.maximum(x, c)`` / ``np.minimum(x, c)`` are ``clamp``, which keeps
     a NaN as NumPy does; ``np.where`` is ``torch.where``.

Term map onto the paper's Sec. VII cost model (and the scalar code):

  * **compute** (Sec. VII-A): per-layer FLOPs / (peak·efficiency),
    MP-sharded — ``flops · samples / mp / eff`` — times the GPipe bubble
    ``(M + S − 1)/M`` (Sec. VII-C) with M = 8 microbatches for
    weight-stationary pipelines;
  * **MP comm** (Sec. VII-B): blocking per-layer All-Reduces, fwd + bwd,
    at the fabric's effective bandwidth — mesh rings: ``2(n−1)`` steps of
    ``2(n−1)/n·D`` endpoint traffic over congested X-Y routes (the
    wafer-wide case switches to the hierarchical-2D algorithm exactly
    where ``n == rows·cols``); FRED trees: 4 fabric traversals of
    (in-network: halved) traffic (Sec. V/VIII) — with ``dp·pp/wafers``
    groups contending for the spine;
  * **EP comm** (MoE lanes with ``ep > 1``): expert dispatch/combine
    All-to-All over the ep-sized strided DP subgroup (stride mp·pp); one
    per-layer MP All-Reduce is subsumed (``mp_ar − 1``), and a
    ``comm_overlap_fraction`` share of the compute hides EP then MP time;
  * **PP comm** (Sec. VII-C): boundary activation transfer per
    microbatch (SP shards the boundary a further ``sp``-way), exposed
    for the ``M + S − 1`` bubble slots;
  * **DP comm** (Sec. VII-B): per-layer gradient All-Reduce — on
    clusters the hierarchical RS(intra) → per-inter-level collectives →
    AG(intra) decomposition of ``cluster.py``, with the level topology
    (ring / fully-connected / switch) and the spanned unit counts
    supplied per lane (:class:`InterLane`) — water-filled against the
    remaining backward compute;
  * **weight streaming + input load** (Sec. III-A, VIII): model streamed
    at the wafer's sustainable I/O rate overlapped with compute + MP;
    minibatch load exposed while I/O is busy.

The engine also evaluates the per-NPU memory-feasibility model
(:func:`repro_torch.core.workloads.memory_bytes_per_npu`) on the device, so
``repro_torch.core.sweep.sweep(engine="batched")`` masks infeasible points in
array math before any per-point Python runs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no ``device`` they raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .cluster import TOPOLOGY_CODES, hierarchy_spans
from .simulator import Breakdown, NPU_PEAK_FLOPS, Simulator
from .workloads import (ACT_REMAT_MULT, BYTES, MemoryModel, Workload,
                        optimizer_bytes_per_param)

# module-level structural memos — keyed by the *topology* identity only
# (mesh rows×cols / FRED group_size), so FRED-C and FRED-D of one shape,
# and every wafer count of a cluster, share entries.  Under a DefectMask
# the key additionally carries the (hashable, frozen) mask, since the
# compacted groups' structure depends on where the holes are.
_RING_STRUCTS: Dict[tuple, Tuple[int, float]] = {}
_SPAN_STRUCTS: Dict[tuple, Tuple[int, int]] = {}
_MASKED_SPAN_STRUCTS: Dict[tuple, Tuple[int, int, float]] = {}


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is ``cuda``, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the batched cost model runs on device 'cuda' by default, and "
                "torch.cuda.is_available() is False; pass device='cpu' to run it "
                "on the CPU")
        device = "cuda"
    return torch.device(device)


def _f(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64)


def _unique_rows(arrs: Sequence[np.ndarray]
                 ) -> Tuple[List[Tuple[int, ...]], np.ndarray]:
    """(unique rows as int tuples, inverse indices) for parallel int64
    columns — bytewise void-view dedup, far faster than unique(axis=0)."""
    key = np.stack(arrs, axis=1)
    kv = np.ascontiguousarray(key).view(
        np.dtype((np.void, key.shape[1] * 8))).ravel()
    _, first, inv = np.unique(kv, return_index=True, return_inverse=True)
    return [tuple(r) for r in key[first].tolist()], inv


def _ring_structures_np(rows: int, cols: int, counts: np.ndarray,
                        strides: np.ndarray
                        ) -> List[Tuple[int, float]]:
    """NumPy twin of :meth:`MeshFabric.ring_structure` for a *batch* of
    strided rings on one rows×cols mesh.

    Counts the directed X-Y unit links of every ring edge with
    difference-array sweeps over four (pattern × row/col × direction)
    planes — exact integer congestion and the same ``tot / n`` mean-hops
    ratio, so each result is identical to the scalar walk; a constant
    number of array ops covers every pattern of a 500-NPU sweep at once."""
    counts = np.asarray(counts, dtype=np.int64)
    strides = np.asarray(strides, dtype=np.int64)
    n_pat = len(counts)
    pid = np.repeat(np.arange(n_pat), counts)
    idx = np.arange(counts.sum()) - np.repeat(counts.cumsum() - counts,
                                              counts)
    s_rep = np.repeat(strides, counts)
    v = idx * s_rep
    nxt = np.where(idx + 1 < np.repeat(counts, counts), idx + 1, 0) * s_rep
    r0, c0 = v // cols, v % cols
    r1, c1 = nxt // cols, nxt % cols
    dh = c1 - c0
    dv = r1 - r0
    tot = np.bincount(pid, weights=_f(np.abs(dh) + np.abs(dv)),
                      minlength=n_pat)
    cong = np.zeros(n_pat, dtype=np.int64)
    # horizontal links live on row r0 (X first), vertical on column c1
    for sel, axis_idx, lo, hi, n_axes, width in (
            (dh > 0, r0, c0, c1, rows, cols),
            (dh < 0, r0, c1, c0, rows, cols),
            (dv > 0, c1, r0, r1, cols, rows),
            (dv < 0, c1, r1, r0, cols, rows)):
        if not sel.any():
            continue
        diff = np.zeros((n_pat, n_axes, width + 1), dtype=np.int64)
        np.add.at(diff, (pid[sel], axis_idx[sel], lo[sel]), 1)
        np.add.at(diff, (pid[sel], axis_idx[sel], hi[sel]), -1)
        cong = np.maximum(cong, diff.cumsum(axis=2).max(axis=(1, 2)))
    cong = np.maximum(cong, 1)
    hops = np.maximum(tot / counts, 1.0)
    return list(zip(cong.tolist(), hops.tolist()))


def _span_structures_np(group_size: int, counts: np.ndarray,
                        strides: np.ndarray) -> List[Tuple[int, int]]:
    """NumPy twin of :meth:`FredFabric.span_structure` for a batch of
    strided groups: (L1 switches spanned, max members under one L1)."""
    counts = np.asarray(counts, dtype=np.int64)
    strides = np.asarray(strides, dtype=np.int64)
    n_pat = len(counts)
    pid = np.repeat(np.arange(n_pat), counts)
    idx = np.arange(counts.sum()) - np.repeat(counts.cumsum() - counts,
                                              counts)
    l1 = (idx * np.repeat(strides, counts)) // group_size
    n_l1 = int(l1.max()) + 1
    per = np.bincount(pid * n_l1 + l1,
                      minlength=n_pat * n_l1).reshape(n_pat, n_l1)
    g = (per > 0).sum(axis=1)
    k = per.max(axis=1)
    return list(zip(g.tolist(), k.tolist()))


@dataclasses.dataclass
class InterLane:
    """Per-lane inter-level structure for fused cluster runs.

    One entry per candidate lane: how many inter levels its configuration
    stacks (``n_levels``: 0 = single wafer), the topology code of each
    level (``TOPOLOGY_CODES``), and the units spanned at each level by
    the lane's cross-wafer DP group (``span1``/``span2`` — precomputed
    via :func:`repro_torch.core.cluster.hierarchy_spans`, 1 where a level
    is absent or not crossed).  The engine supports up to two inter levels
    (wafer → rack → pod), matching the sweep's ``max_levels`` cap."""
    n_levels: np.ndarray
    topo1: np.ndarray
    topo2: np.ndarray
    span1: np.ndarray
    span2: np.ndarray

    @classmethod
    def for_config(cls, n_lanes: int, wafers: int, counts: Sequence[int],
                   topology: str) -> "InterLane":
        """Constant lanes for one (wafer count, hierarchy, topology)
        configuration — every candidate of a sweep configuration spans
        the same ``wafers``."""
        if len(counts) > 2:
            raise NotImplementedError(
                f"batched engine supports ≤ 2 inter levels, got {counts}")
        spans = hierarchy_spans(wafers, counts) + [1, 1]
        code = TOPOLOGY_CODES[topology] if topology else 0
        full = lambda v: np.full(n_lanes, v, dtype=np.int64)
        return cls(full(len(counts)), full(code), full(code),
                   full(spans[0]), full(spans[1]))

    @classmethod
    def concat(cls, parts: Sequence["InterLane"]) -> "InterLane":
        if len(parts) == 1:
            return parts[0]
        return cls(*(np.concatenate([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(cls)))

    def take(self, indices: Sequence[int]) -> "InterLane":
        idx = np.asarray(indices, dtype=np.int64)
        return InterLane(*(getattr(self, f.name)[idx]
                           for f in dataclasses.fields(InterLane)))


class CandidateBatch:
    """Fabric-independent per-candidate parameter arrays (host, NumPy).

    Packs the strategy and workload scalars :meth:`Simulator.run` reads
    into ``int64``/``float64`` arrays once; the sweep builds one pack per
    wafer count and reuses it across every (fabric, shape) it visits.
    """

    _ARRAYS = ("mp", "dp", "pp", "wafers", "ep", "sp", "n_layers", "mp_ar",
               "samples", "minibatch", "seq", "params_layer", "flops",
               "abps", "pbt", "kv_layer", "a2a_layer", "expert_frac",
               "streaming")
    _INTS = _ARRAYS[:11]
    _FLOATS = _ARRAYS[11:18]
    __slots__ = ("workloads",) + _ARRAYS

    def __init__(self, workloads: Sequence[Workload]):
        self.workloads = list(workloads)
        n = len(self.workloads)
        ints = np.empty((11, n), dtype=np.int64)
        flts = np.empty((7, n), dtype=np.float64)
        streaming = np.empty(n, dtype=bool)
        for i, w in enumerate(self.workloads):
            st = w.strategy
            ints[0, i] = st.mp
            ints[1, i] = st.dp
            ints[2, i] = st.pp
            ints[3, i] = st.wafers
            ints[4, i] = st.ep
            ints[5, i] = st.sp
            ints[6, i] = w.n_layers
            ints[7, i] = w.mp_allreduce_per_layer
            ints[8, i] = w.samples_per_dp
            ints[9, i] = w.minibatch
            ints[10, i] = w.seq
            flts[0, i] = w.params_per_layer
            flts[1, i] = w.flops_fwd_per_sample_layer
            flts[2, i] = w.act_bytes_per_sample
            flts[3, i] = w.param_bytes_total
            flts[4, i] = w.kv_bytes_per_sample_layer
            flts[5, i] = w.a2a_bytes_per_sample_layer
            flts[6, i] = w.expert_param_fraction
            streaming[i] = w.execution == "streaming"
        (self.mp, self.dp, self.pp, self.wafers, self.ep, self.sp,
         self.n_layers, self.mp_ar, self.samples, self.minibatch,
         self.seq) = ints
        (self.params_layer, self.flops, self.abps, self.pbt,
         self.kv_layer, self.a2a_layer, self.expert_frac) = flts
        self.streaming = streaming

    def __len__(self) -> int:
        return len(self.workloads)

    def take(self, indices: Sequence[int]) -> "CandidateBatch":
        """Sub-batch at ``indices`` (used to evaluate only the symmetry-
        pruned representatives)."""
        sub = object.__new__(CandidateBatch)
        sub.workloads = [self.workloads[i] for i in indices]
        idx = np.asarray(indices, dtype=np.int64)
        for name in self._ARRAYS:
            setattr(sub, name, getattr(self, name)[idx])
        return sub

    @classmethod
    def concat(cls, parts: Sequence["CandidateBatch"]) -> "CandidateBatch":
        """Fuse several packs into one lane space — the sweep evaluates
        every (shape, wafer count) configuration of a fabric in a single
        vectorized call and slices the results back per configuration."""
        if len(parts) == 1:
            return parts[0]
        fused = object.__new__(cls)
        fused.workloads = [w for p in parts for w in p.workloads]
        for name in cls._ARRAYS:
            setattr(fused, name,
                    np.concatenate([getattr(p, name) for p in parts]))
        return fused


class _Lanes:
    """Named host lanes shipped to the device in two copies: every ``int64``
    (and bool) lane in one stack, every ``float64`` lane in another; each
    name then reads a row of the device stack."""

    def __init__(self):
        self.ints: Dict[str, np.ndarray] = {}
        self.flts: Dict[str, np.ndarray] = {}

    def ship(self, device: torch.device, copies: Dict[str, int]
             ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for names, arrs, dtype in ((list(self.ints), self.ints, np.int64),
                                   (list(self.flts), self.flts, np.float64)):
            if not names:
                continue
            host = np.stack([np.asarray(arrs[k], dtype=dtype) for k in names])
            dev = torch.from_numpy(host).to(device)
            copies["h2d"] += 1
            for j, k in enumerate(names):
                out[k] = dev[j]
        return out


def _to_host(cols: Sequence[torch.Tensor], copies: Dict[str, int]) -> np.ndarray:
    """One device-to-host copy of the stacked float64 result columns."""
    host = torch.stack(list(cols)).cpu().numpy()
    copies["d2h"] += 1
    return host


class BatchEngine:
    """Vectorized evaluator bound to one :class:`Simulator` (one fabric ×
    wafer shape × wafer count).  ``run_batch`` maps a list of Workloads
    (each carrying its strategy) to Breakdowns bit-identical to
    ``[sim.run(w) for w in workloads]``.  Its float math runs on
    ``device`` (``cuda`` unless given).  After each ``run_batch``, ``copies``
    counts its host-to-device and device-to-host copies, and ``seconds``
    splits its host clock: ``lanes`` (validation, integer lanes, structure
    tables, the copies in), ``math`` (the float math to its copy back, which
    waits for the device) and ``breakdowns`` (the result objects)."""

    def __init__(self, sim: Simulator, device=None):
        self.sim = sim
        self.device = resolve_device(device)
        if getattr(self.sim, "wafer_defects", None) is not None:
            raise NotImplementedError(
                "per-wafer defect masks (ClusterSpec.wafer_defects) are a "
                "scalar-Simulator feature, not a sweep axis — the batched "
                "engine only models the uniform FabricSpec.defects mask")
        self._io_rate = self.sim._io_rate()
        self._gs_lane: Optional[np.ndarray] = None   # per-lane FRED group
                                                     # sizes in fused runs
        self.copies = {"h2d": 0, "d2h": 0}
        self.seconds = {"lanes": 0.0, "math": 0.0, "breakdowns": 0.0}

    def _c(self, value: float) -> torch.Tensor:
        """A constant as a 0-dim float64 tensor made on the device (a fill,
        not a copy): dividing by it, or it by a tensor, is a true division."""
        return torch.full((), value, dtype=torch.float64, device=self.device)

    # ---- structural tables (host; one batched computation per missing
    # ---- pattern) -----------------------------------------------------------
    def _ring_structs(self, counts: np.ndarray, strides: np.ndarray,
                      needed: Optional[np.ndarray] = None,
                      used: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        mesh = self.sim.mesh
        rows, cols = mesh.rows, mesh.cols
        d = mesh.defects
        if d is not None:
            # masked structures come from the scalar defect-aware walk on
            # the compacted group family (detours and congestion depend on
            # where the holes are, not just on the (count, stride)
            # pattern).  ``used`` is the per-lane NPUs-used-per-wafer the
            # strided concurrent-group family tiles (meshnet
            # strided_ring_family) — the evaluated ring pays the max
            # shared-link load over the whole family, exactly like the
            # scalar path's concurrent_rings; None falls back to the
            # single representative ring.  ``needed`` marks the lanes the
            # scalar engine actually evaluates: a hole-disconnected ring
            # must raise exactly when the scalar path would route it, and
            # stay silent (neutral structure, result masked out
            # downstream) when it would not.
            from .meshnet import strided_ring_family
            if used is None:
                used = np.zeros_like(counts)
            uniq, inv = _unique_rows((counts, strides, used))
            healthy = d.healthy()
            m = len(uniq)
            if needed is None:
                pat_needed = np.ones(m, dtype=bool)
            else:
                pat_needed = np.bincount(inv[np.asarray(needed, bool)],
                                         minlength=m) > 0
            cong = np.empty(m, dtype=np.int64)
            hops = np.empty(m, dtype=np.float64)
            for j, (c, s, u) in enumerate(uniq):
                if c <= 1 or not pat_needed[j]:
                    cong[j], hops[j] = 1, 1.0
                    continue
                key = (rows, cols, c, s, u, d)
                st = _RING_STRUCTS.get(key)
                if st is None:
                    fam = strided_ring_family(healthy, c, s, u)
                    st = (max(mesh.ring_max_congestion(fam), 1),
                          mesh._ring_hops(fam[0]))
                    _RING_STRUCTS[key] = st
                cong[j], hops[j] = st
            return cong[inv], hops[inv]
        uniq, inv = _unique_rows((counts, strides))
        missing = [(c, s) for c, s in uniq
                   if c > 1 and (rows, cols, c, s) not in _RING_STRUCTS]
        if missing:
            mc = np.array([p[0] for p in missing], dtype=np.int64)
            ms = np.array([p[1] for p in missing], dtype=np.int64)
            for p, st in zip(missing, _ring_structures_np(rows, cols,
                                                          mc, ms)):
                _RING_STRUCTS[(rows, cols) + p] = st
        m = len(uniq)
        cong = np.empty(m, dtype=np.int64)
        hops = np.empty(m, dtype=np.float64)
        for j, (c, s) in enumerate(uniq):
            cong[j], hops[j] = (_RING_STRUCTS[(rows, cols, c, s)]
                                if c > 1 else (1, 1.0))
        return cong[inv], hops[inv]

    def _span_structs(self, counts: np.ndarray, strides: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(g, k, uplink-factor) lanes; the factor lane is ``None`` without
        a defect mask so the zero-defect formulas never see it."""
        gsl = self._gs_lane
        fred = self.sim.fred
        if gsl is None:
            gs0 = fred.group_size
            uniq, inv = _unique_rows((counts, strides))
            triples = [(gs0, c, s) for c, s in uniq]
        else:
            uniq, inv = _unique_rows((gsl, counts, strides))
            triples = [tuple(t) for t in uniq]
        d = fred.defects
        if d is not None:
            m = len(triples)
            g = np.empty(m, dtype=np.int64)
            k = np.empty(m, dtype=np.int64)
            fac = np.empty(m, dtype=np.float64)
            for j, t in enumerate(triples):
                g[j], k[j], fac[j] = (self._masked_span(t, d) if t[1] > 1
                                      else (1, 1, 1.0))
            return g[inv], k[inv], fac[inv]
        missing = [t for t in triples
                   if t[1] > 1 and t not in _SPAN_STRUCTS]
        if missing:
            by_gs: Dict[int, List[Tuple[int, ...]]] = {}
            for t in missing:
                by_gs.setdefault(t[0], []).append(t)
            for gs, pats in by_gs.items():
                mc = np.array([t[1] for t in pats], dtype=np.int64)
                ms = np.array([t[2] for t in pats], dtype=np.int64)
                for t, st in zip(pats, _span_structures_np(gs, mc, ms)):
                    _SPAN_STRUCTS[t] = st
        m = len(triples)
        g = np.empty(m, dtype=np.int64)
        k = np.empty(m, dtype=np.int64)
        for j, t in enumerate(triples):
            g[j], k[j] = _SPAN_STRUCTS[t] if t[1] > 1 else (1, 1)
        return g[inv], k[inv], None

    def _masked_span(self, triple: Tuple[int, int, int], d
                     ) -> Tuple[int, int, float]:
        """(g, k, uplink factor) of one (group_size, count, stride) pattern
        compacted onto the mask's healthy NPUs — the same quantities
        :meth:`FredFabric.span_structure` / :meth:`FredFabric
        .uplink_factor` derive for the compacted group, with the lane's
        group size standing in for the bound fabric's (fused runs)."""
        key = triple + (d,)
        st = _MASKED_SPAN_STRUCTS.get(key)
        if st is None:
            gs, c, s = triple
            healthy = d.healthy()
            span: Dict[int, int] = {}
            for i in range(c):
                l1 = healthy[i * s] // gs
                span[l1] = span.get(l1, 0) + 1
            f = 1.0
            if d.dead_uplinks:
                up = self.sim.fred.uplinks_per_l1()
                for l1 in span:
                    f = min(f, max(1, up - d.dead_uplinks_of(l1)) / up)
            st = (len(span), max(span.values()), f)
            _MASKED_SPAN_STRUCTS[key] = st
        return st

    def _wafer_struct(self, lanes: _Lanes, tag: str, counts: np.ndarray,
                      strides, needed: Optional[np.ndarray] = None,
                      used: Optional[np.ndarray] = None) -> None:
        """The structure lanes of one intra-wafer (count, stride) pattern,
        added to ``lanes`` under ``tag``: a mesh ring's (cong, hops), a FRED
        group's (g, k, uplink factor or none).  Healthy mesh rings ignore
        concurrency exactly like the scalar path (disjoint X-Y rings); under
        a defect mask ``used`` keys the concurrent-ring family whose
        shared-link detour congestion the evaluated ring pays."""
        strides = np.broadcast_to(np.asarray(strides, dtype=np.int64),
                                  counts.shape)
        if self.sim.mesh is not None:
            cong, hops = self._ring_structs(counts, strides, needed=needed,
                                            used=used)
            lanes.ints[tag + "cong"] = cong
            lanes.flts[tag + "hops"] = hops
            return
        g, k, fac = self._span_structs(counts, strides)
        lanes.ints[tag + "g"] = g
        lanes.ints[tag + "k"] = k
        if fac is not None:
            lanes.flts[tag + "fac"] = fac

    # ---- fabric formulas on the device (op-for-op the scalar formulas) -----
    def _mesh_coll(self, kind: str, n: torch.Tensor, cong: torch.Tensor,
                   hops: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
        """:meth:`MeshFabric.collective_time` over lanes — wafer-wide
        hierarchical-2D branch selected exactly where ``n == mesh.n``."""
        mesh = self.sim.mesh
        nf = n.double()
        if kind == "all_reduce":
            traffic = 2.0 * (nf - 1) / nf * nbytes
        else:
            traffic = (nf - 1) / nf * nbytes
        # the hierarchical-2D algorithm needs the full defect-free
        # rectangle — any hole degrades to the generic ring branch
        wafer = (n == mesh.n if mesh.defects is None
                 else torch.zeros_like(n, dtype=torch.bool))
        steps_w = 2 * ((mesh.cols - 1) + (mesh.rows - 1))
        if kind != "all_reduce":
            steps_w //= 2
        steps_r = 2 * (n - 1) if kind == "all_reduce" else (n - 1)
        steps = torch.where(wafer, steps_w, steps_r)
        bw = torch.where(wafer, mesh.wafer_wide_allreduce_bw(),
                         self._c(mesh.link_bw) / cong.double())
        h = torch.where(wafer, 1.0, hops)
        chunk = traffic / steps.clamp(min=1)
        per_step = (chunk / bw + mesh.latency_per_hop * h +
                    mesh.step_overhead)
        return torch.where((n <= 1) | (nbytes <= 0), 0.0, steps * per_step)

    def _fred_coll(self, kind: str, n: torch.Tensor, g: torch.Tensor,
                   k: torch.Tensor, conc: torch.Tensor, nbytes: torch.Tensor,
                   l2f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`FredFabric.collective_time` (incl. ``effective_npu_bw``)
        over lanes.  ``l2f`` is the per-lane uplink surviving-fraction
        under a defect mask (None without one — the raw-constant spine
        bandwidth path is kept byte-for-byte)."""
        cfg = self.sim.fred.config
        nf = n.double()
        if cfg.in_network:
            if kind == "all_reduce":
                traffic = nbytes
            else:
                traffic = (nf - 1) / nf * nbytes
            steps = torch.where(g > 1, 4, 2)
        else:
            if kind == "all_reduce":
                traffic = 2.0 * (nf - 1) / nf * nbytes
            else:
                traffic = (nf - 1) / nf * nbytes
            steps = torch.where(g > 1, 2 * (k - 1) + 2 * (g - 1), 2 * (n - 1))
            steps = steps.clamp(min=2)
            if kind != "all_reduce":
                steps = (steps // 2).clamp(min=1)
        if l2f is None:
            l2 = self._c(cfg.l1_l2_bw)
        else:                  # severed uplinks shrink the spine BW —
            # same op order as the scalar branch (multiply, then divide)
            l2 = torch.where(l2f != 1.0, cfg.l1_l2_bw * l2f, cfg.l1_l2_bw)
        share = l2 / (k * conc).clamp(min=1).double()
        if cfg.in_network:
            bw_multi = (l2 / conc.clamp(min=1).double()).clamp(
                max=cfg.npu_l1_bw)
        else:
            bw_multi = torch.where(k > 1,
                                   (share * (1 + k)).clamp(max=cfg.npu_l1_bw),
                                   share.clamp(max=cfg.npu_l1_bw))
        bw = torch.where(g <= 1, cfg.npu_l1_bw, bw_multi)
        per_step = ((traffic / steps.clamp(min=1)) / bw +
                    cfg.switch_latency + cfg.step_overhead)
        return torch.where((n <= 1) | (nbytes <= 0), 0.0, steps * per_step)

    def _wafer_coll(self, kind: str, T: Dict[str, torch.Tensor], tag: str,
                    counts: torch.Tensor, conc: torch.Tensor,
                    nbytes: torch.Tensor) -> torch.Tensor:
        """One intra-wafer collective over the pattern whose structure lanes
        ``_wafer_struct`` shipped under ``tag``.  FRED models concurrency via
        the ``conc`` bandwidth share."""
        if self.sim.mesh is not None:
            return self._mesh_coll(kind, counts, T[tag + "cong"],
                                   T[tag + "hops"], nbytes)
        return self._fred_coll(kind, counts, T[tag + "g"], T[tag + "k"], conc,
                               nbytes, l2f=T.get(tag + "fac"))

    def _level_coll(self, kind: str, topo: torch.Tensor, n: torch.Tensor,
                    conc: torch.Tensor, nbytes: torch.Tensor, agg_bw: float,
                    latency: float) -> torch.Tensor:
        """:func:`repro_torch.core.cluster.level_collective_time` over lanes
        — every topology branch evaluated with the scalar op order and
        selected per lane by ``topo`` code."""
        nf = n.double()
        bw = self._c(agg_bw) / conc.clamp(min=1).double()
        ar = kind == "all_reduce"
        # ring: endpoint traffic over 2(n−1) (AR) / (n−1) (RS/AG) steps
        tr_ring = (2.0 * (nf - 1) / nf if ar else (nf - 1) / nf) * nbytes
        steps_ring = 2 * (n - 1) if ar else (n - 1)
        t_ring = steps_ring * ((tr_ring / steps_ring.clamp(min=1)) / bw +
                               latency)
        # fully connected: the D/n shard moves over n−1 parallel peer
        # links; 2 latency steps (RS + AG phase) for the All-Reduce
        shard = nbytes / nf
        per_link_bw = bw / (nf - 1).clamp(min=1)
        steps_fc = 2 if ar else 1
        t_fc = steps_fc * (shard / per_link_bw + latency)
        # switch: in-network reduction — All-Reduce injects D, not
        # 2(n−1)/n·D (switch.py R/D µswitch semantics)
        tr_sw = nbytes if ar else (nf - 1) / nf * nbytes
        steps_sw = 2 if ar else 1
        t_sw = steps_sw * ((tr_sw / self._c(steps_sw)) / bw + latency)
        t = torch.where(topo == 0, t_ring, torch.where(topo == 1, t_fc, t_sw))
        return torch.where((n <= 1) | (nbytes <= 0), 0.0, t)

    def _derived_inter_lane(self, wafers: np.ndarray) -> InterLane:
        """InterLane from the bound cluster's own levels (direct
        ``run_batch`` calls outside the sweep): spans depend only on the
        lane's wafer count — computed once per distinct value."""
        levels = self.sim.cluster.levels
        if len(levels) > 2:
            raise NotImplementedError(
                f"batched engine supports ≤ 2 inter levels, got "
                f"{len(levels)}")
        n = len(wafers)
        full = lambda v: np.full(n, v, dtype=np.int64)
        topo1 = full(TOPOLOGY_CODES[levels[0].topology])
        topo2 = full(TOPOLOGY_CODES[levels[-1].topology])
        span1 = np.ones(n, dtype=np.int64)
        span2 = np.ones(n, dtype=np.int64)
        for w in np.unique(wafers).tolist():
            spans = self.sim.cluster.spans_for(int(w)) + [1, 1]
            sel = wafers == w
            span1[sel] = spans[0]
            span2[sel] = spans[1]
        return InterLane(full(len(levels)), topo1, topo2, span1, span2)

    # ---- validation (scalar-path error parity) ------------------------------
    def _validate(self, b: CandidateBatch) -> None:
        sim = self.sim
        npw = (sim.cluster.npus_per_wafer if sim.cluster is not None
               else sim.n_npus)
        per_wafer_arr = b.mp * b.pp * (b.dp // np.maximum(b.wafers, 1))
        dpw_arr = b.dp // np.maximum(b.wafers, 1)
        bad = (per_wafer_arr > npw) | \
            (b.pp > b.n_layers) | (b.dp % np.maximum(b.wafers, 1) != 0) | \
            ((b.ep > 1) & (dpw_arr % np.maximum(b.ep, 1) != 0)) | \
            ((b.sp > 1) & (b.mp % np.maximum(b.sp, 1) != 0))
        if sim.cluster is None:
            bad |= b.wafers > 1
        else:
            bad |= b.wafers > sim.n_wafers
        if sim.defects is not None:
            bad |= per_wafer_arr > sim.defects.n_healthy
        if not bad.any():
            return
        for w in b.workloads:            # re-derive the precise message
            st = w.strategy
            if sim.cluster is None and st.wafers > 1:
                raise ValueError(
                    f"{st} spans {st.wafers} wafers but this "
                    f"simulator models a single wafer (n_wafers=1)")
            if sim.cluster is not None:
                if st.wafers > sim.n_wafers:
                    raise ValueError(f"{st} spans {st.wafers} wafers, "
                                     f"cluster has {sim.n_wafers}")
                if st.dp % st.wafers != 0:
                    raise ValueError(
                        f"{st}: dp={st.dp} not divisible by wafers="
                        f"{st.wafers} — DP replicas map whole onto wafers")
            per_wafer = st.mp * st.pp * (st.dp // st.wafers)
            if per_wafer > npw:
                raise ValueError(f"{st} needs {per_wafer} NPUs per wafer, "
                                 f"wafer has {npw}")
            if sim.defects is not None and per_wafer > sim.defects.n_healthy:
                raise ValueError(
                    f"{st} needs {per_wafer} healthy NPUs per wafer, "
                    f"defect mask leaves {sim.defects.n_healthy}")
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

    # ---- main ----------------------------------------------------------------
    def run_batch(self, batch: Union[CandidateBatch, Sequence[Workload]],
                  indices: Optional[Sequence[int]] = None,
                  gs_lane: Optional[np.ndarray] = None,
                  inter_lane: Optional[InterLane] = None) -> List[Breakdown]:
        """Evaluate every candidate (with its own strategy) on this fabric.

        ``batch`` is a :class:`CandidateBatch` or a plain Workload list
        (packed on the fly); ``indices`` restricts evaluation to a
        sub-batch.  ``gs_lane`` supplies per-lane FRED group sizes when
        the batch fuses several wafer shapes of one FRED config (the
        only shape-dependent input of the FRED formulas); ``inter_lane``
        supplies the per-lane inter-level structure when the batch fuses
        several (hierarchy, inter topology) configurations of one cluster
        (absent, it is derived from the bound cluster's own levels).
        Returns Breakdowns bit-identical to the scalar reference — the
        same IEEE-754 ops in the same order."""
        sim = self.sim
        t0 = time.perf_counter()
        self.copies = {"h2d": 0, "d2h": 0}
        if not isinstance(batch, CandidateBatch):
            batch = CandidateBatch(batch)
        if indices is not None:
            batch = batch.take(indices)
            if gs_lane is not None:
                gs_lane = np.asarray(gs_lane)[np.asarray(indices)]
            if inter_lane is not None:
                inter_lane = inter_lane.take(indices)
        if not len(batch):
            return []
        self._gs_lane = gs_lane
        self._validate(batch)
        b = batch

        # ---- host: the integer lanes and the structure tables --------------
        L = _Lanes()
        for name in CandidateBatch._INTS:
            L.ints[name] = getattr(b, name)
        for name in CandidateBatch._FLOATS:
            L.flts[name] = getattr(b, name)
        mp, dp, pp, wafers = b.mp, b.dp, b.pp, b.wafers
        streaming = b.streaming
        stationary = ~streaming
        layers = -(-b.n_layers // pp)                 # ceil(n_layers / pp)
        mb = np.where((pp > 1) & stationary, 8, np.maximum(pp, 1))
        ep_mask = (b.ep > 1) & (b.a2a_layer > 0.0)
        mp_ar = np.where(ep_mask & (b.mp_ar > 0), b.mp_ar - 1, b.mp_ar)
        mp_mask = (mp > 1) & (mp_ar > 0)
        # per-lane NPUs used per wafer — the strided concurrent-group
        # family extent every axis' masked ring congestion is keyed on
        used = mp * pp * (dp // np.maximum(wafers, 1))
        dp_mask = (dp > 1) & stationary
        stride = mp * pp
        L.ints.update(streaming=streaming, layers=layers, mb=mb,
                      ep_mask=ep_mask, mp_ar_eff=mp_ar, mp_mask=mp_mask,
                      dp_mask=dp_mask)
        self._wafer_struct(L, "mp_", mp, 1, needed=mp_mask, used=used)
        # EP groups are ep consecutive DP peers (stride mp·pp), always
        # within one wafer — the same strided structural tables as MP/DP
        self._wafer_struct(L, "ep_", b.ep, stride, needed=ep_mask, used=used)
        n_lvl = np.zeros_like(dp)
        if sim.cluster is not None:
            if inter_lane is None:
                inter_lane = self._derived_inter_lane(wafers)
            n_lvl = inter_lane.n_levels
            multi = wafers > 1
            counts = np.where(multi, dp // wafers, dp)
            # one structural lookup serves AR, RS and AG (same pattern)
            self._wafer_struct(L, "dp_", counts, stride, needed=dp_mask,
                               used=used)
            L.ints.update(multi=multi, dp_counts=counts,
                          topo1=inter_lane.topo1, topo2=inter_lane.topo2,
                          span1=inter_lane.span1, span2=inter_lane.span2)
        else:
            self._wafer_struct(L, "dp_", dp, stride, needed=dp_mask, used=used)
        T = L.ship(self.device, self.copies)
        t1 = time.perf_counter()

        # ---- device: the float math ----------------------------------------
        mp, dp, pp, wafers = T["mp"], T["dp"], T["pp"], T["wafers"]
        streaming = T["streaming"] != 0
        layers, mb = T["layers"], T["mb"]

        # compute (Sec. VII-A + GPipe bubble, Sec. VII-C)
        eff_flops = NPU_PEAK_FLOPS * sim.compute_efficiency
        fwd_layer = T["flops"] * T["samples"] / mp / self._c(eff_flops)
        bwd_layer = 2 * fwd_layer
        fwd_stage = fwd_layer * layers
        bwd_stage = bwd_layer * layers
        bubble = torch.where(pp > 1, (mb + pp - 1).double() / mb.double(), 1.0)
        compute = (fwd_stage + bwd_stage) * bubble

        # MP comm (Sec. VII-B): per-layer All-Reduce, fwd + bwd; with EP
        # active the expert-dispatch All-to-All subsumes the FFN
        # All-Reduce — one fewer MP sync per layer (scalar: mp_ar − 1)
        act_bytes = T["abps"] * T["samples"]
        mp_conc = ((dp * pp) // wafers).clamp(min=1)
        per_layer = self._wafer_coll("all_reduce", T, "mp_", mp, mp_conc,
                                     act_bytes)
        mp_time = torch.where(T["mp_mask"] != 0,
                              per_layer * T["mp_ar_eff"] * 2 * layers * bubble,
                              0.0)

        # EP comm: expert dispatch/combine All-to-All
        ep = T["ep"]
        a2a_bytes = T["a2a_layer"] * T["samples"]
        ep_conc = ((mp * pp * dp) // (ep * wafers)).clamp(min=1)
        per_layer_ep = self._wafer_coll("all_to_all", T, "ep_", ep, ep_conc,
                                        a2a_bytes)
        ep_raw = torch.where(T["ep_mask"] != 0,
                             per_layer_ep * 2 * 2 * layers * bubble, 0.0)

        # compute/comm overlap (EP first, then MP)
        overlappable = sim.comm_overlap_fraction * compute
        ep_time = (ep_raw - overlappable).clamp(min=0.0)
        rem = (overlappable - ep_raw).clamp(min=0.0)
        mp_time = (mp_time - rem).clamp(min=0.0)
        exposed_comm = mp_time + ep_time

        # PP comm (Sec. VII-C): boundary transfer per microbatch
        pp_bw = (sim.mesh.link_bw if sim.mesh is not None
                 else sim.fred.config.npu_l1_bw)
        per_mb = 2 * ((act_bytes / mb / T["sp"]) / self._c(pp_bw))
        pp_time = torch.where(pp > 1, per_mb * (mb + pp - 1), 0.0)

        # DP comm (Sec. VII-B, hierarchical on clusters)
        grad = T["params_layer"] * BYTES / mp
        dp_mask = T["dp_mask"] != 0
        n_dp_groups = mp * pp
        if sim.cluster is not None:
            multi = T["multi"] != 0
            counts = T["dp_counts"]
            # RS and AG are bit-equal by construction (the formulas only
            # branch on all_reduce vs not), mirroring the scalar engine
            # computing both to the same value
            t_ar = self._wafer_coll("all_reduce", T, "dp_", counts,
                                    n_dp_groups, grad)
            t_rs = self._wafer_coll("reduce_scatter", T, "dp_", counts,
                                    n_dp_groups, grad)
            intra_multi = torch.where(counts > 1, t_rs + t_rs, 0.0)
            ti = torch.where(multi, intra_multi, t_ar)
            # per-level inter terms — level 1 runs RS+AG when a spanned
            # level sits above it, All-Reduce when it is the outermost
            # (the scalar decomposition of WaferCluster._level_times);
            # only the mp groups of one pipeline stage contend on the
            # inter links (inter_concurrent = mp, as in the scalar path)
            agg1, lat1 = sim.cluster.level_params(0)
            agg2, lat2 = sim.cluster.level_params(1)
            s1, s2 = T["span1"], T["span2"]
            ar1 = self._level_coll("all_reduce", T["topo1"], s1, mp, grad,
                                   agg1, lat1)
            rs1 = self._level_coll("reduce_scatter", T["topo1"], s1, mp,
                                   grad, agg1, lat1)
            ag1 = self._level_coll("all_gather", T["topo1"], s1, mp, grad,
                                   agg1, lat1)
            te1 = torch.where(multi & (s2 > 1), rs1 + ag1,
                              torch.where(multi, ar1, 0.0))
            te2 = torch.where(multi,
                              self._level_coll("all_reduce", T["topo2"], s2,
                                               mp, grad, agg2, lat2), 0.0)
        else:
            ti = self._wafer_coll("all_reduce", T, "dp_", dp, n_dp_groups,
                                  grad)
            te1 = torch.zeros_like(ti)
            te2 = torch.zeros_like(ti)
        dp_intra, lvl1, lvl2 = _iterated_layer_sum(
            ti, te1, te2, layers, dp_mask, L.ints["layers"],
            L.ints["dp_mask"])
        dp_inter = lvl1 + lvl2
        total_ar = dp_intra + dp_inter
        if sim.overlap_dp:
            exposed_dp = (total_ar - bwd_stage * (
                1 - self._c(1.0) / layers.clamp(min=1).double())).clamp(min=0.0)
        else:
            exposed_dp = total_ar
        dp_time = torch.where(dp_mask, exposed_dp, 0.0)

        # weight streaming + input load (Sec. III-A, VIII)
        io_rate = self._c(self._io_rate)
        stream_bytes = T["pbt"] * (2 + 1) / pp
        io_time = stream_bytes / io_rate
        stream_time = torch.where(
            streaming, (io_time - compute - mp_time).clamp(min=0.0), 0.0)
        in_bytes = T["minibatch"] * T["abps"]
        input_load = torch.where(streaming,
                                 in_bytes / (io_rate * wafers.double()), 0.0)

        # one copy to the host, then bulk-convert to Python floats (tolist
        # is C-speed) and bypass the dataclass __init__ — Breakdown
        # construction is the hottest remaining per-point Python
        host = _to_host((compute, input_load, mp_time, dp_time, pp_time,
                         stream_time, dp_intra, dp_inter, ep_time,
                         exposed_comm, lvl1, lvl2), self.copies)
        t2 = time.perf_counter()
        cols = host.tolist()
        l1s, l2s = cols[10], cols[11]
        nls = n_lvl.tolist()
        fabric = sim.fabric_name
        new = Breakdown.__new__
        out = []
        for i, w in enumerate(b.workloads):
            nl = nls[i]
            br = new(Breakdown)
            br.__dict__ = {
                "workload": w.name, "fabric": fabric,
                "compute": cols[0][i], "input_load": cols[1][i],
                "mp": cols[2][i], "dp": cols[3][i], "pp": cols[4][i],
                "stream": cols[5][i], "dp_intra": cols[6][i],
                "dp_inter": cols[7][i],
                "dp_levels": (() if nl == 0 else
                              (l1s[i],) if nl == 1 else (l1s[i], l2s[i])),
                "ep_s": cols[8][i], "exposed_comm_s": cols[9][i]}
            out.append(br)
        self.seconds = {"lanes": t1 - t0, "math": t2 - t1,
                        "breakdowns": time.perf_counter() - t2}
        return out


def _iterated_layer_sum(ti: torch.Tensor, te1: torch.Tensor, te2: torch.Tensor,
                        layers: torch.Tensor, mask: torch.Tensor,
                        layers_host: np.ndarray, mask_host: np.ndarray
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-layer DP accumulation replayed as *iterated* float adds.

    The scalar engine adds the per-layer All-Reduce time ``layers`` times
    in a loop; ``layers · t`` would round differently after the third
    add, so bit-parity requires replaying the additions — for the intra
    part and each inter level separately.  Every lane adds its own time
    once a step (the NumPy engine first folds lanes with equal inputs into
    one, which changes no sum); a lane's result is read at the step that
    equals its ``layers``.  The steps and the milestones come from the
    host copies of ``layers`` and ``mask``, so the loop reads nothing back
    from the device."""
    zero = torch.zeros_like(ti)
    sel = layers_host[np.asarray(mask_host, bool)]
    if not len(sel):
        return zero, zero.clone(), zero.clone()
    milestones = set(sel.tolist())
    acc_i = torch.zeros_like(ti)
    acc_1 = torch.zeros_like(ti)
    acc_2 = torch.zeros_like(ti)
    out_i, out_1, out_2 = zero, zero.clone(), zero.clone()
    for step in range(1, int(sel.max()) + 1):
        acc_i = acc_i + ti
        acc_1 = acc_1 + te1
        acc_2 = acc_2 + te2
        if step in milestones:
            hit = mask & (layers == step)
            out_i = torch.where(hit, acc_i, out_i)
            out_1 = torch.where(hit, acc_1, out_1)
            out_2 = torch.where(hit, acc_2, out_2)
    return out_i, out_1, out_2


# --------------------------------------------------------------------------
# vectorized memory-feasibility model
# --------------------------------------------------------------------------

def memory_bytes_batch(batch: Union[CandidateBatch, Sequence[Workload]],
                       mem: MemoryModel, device=None) -> np.ndarray:
    """Vectorized :func:`repro_torch.core.workloads.memory_bytes_per_npu`
    on ``device`` (``cuda`` unless given) — identical op order, so each
    element is bit-equal to the scalar call.  Returns a host array (one
    copy back)."""
    dev = resolve_device(device)
    if not isinstance(batch, CandidateBatch):
        batch = CandidateBatch(batch)
    b = batch
    if not len(b):
        return np.zeros(0)
    copies = {"h2d": 0, "d2h": 0}
    L = _Lanes()
    L.ints.update(mp=b.mp, pp=b.pp, ep=b.ep, sp=b.sp, seq=b.seq,
                  samples=b.samples, streaming=b.streaming,
                  layers=-(-b.n_layers // b.pp))
    L.flts.update(params_layer=b.params_layer, abps=b.abps,
                  kv_layer=b.kv_layer, expert_frac=b.expert_frac)
    T = L.ship(dev, copies)
    mp, layers = T["mp"], T["layers"]
    streaming = T["streaming"] != 0
    stationary = ~streaming
    buffers = 3 if mem.training else 2
    # expert share of the params divides by ep (scalar: ep_share factor;
    # (1−f)+f is not bitwise 1.0, so inactive lanes select the literal)
    f = T["expert_frac"]
    ep_on = (T["ep"] > 1) & (f != 0.0)
    ep_share = torch.where(ep_on, (1.0 - f) + f / T["ep"], 1.0)
    resident = torch.where(streaming,
                           buffers * T["params_layer"] * ep_share / mp,
                           T["params_layer"] * ep_share * layers / mp)
    opt_per_param = optimizer_bytes_per_param(mem.master, mem.moments_dtype)
    if mem.training:
        opt_bytes = torch.where(stationary, resident * opt_per_param, 0.0)
        grad_bytes = torch.where(stationary, resident * BYTES, 0.0)
    else:
        opt_bytes = torch.zeros_like(resident)
        grad_bytes = torch.zeros_like(resident)
    weight_bytes = resident * BYTES

    mult = ACT_REMAT_MULT[mem.remat] if mem.training else 1.0
    act_layers = layers if mem.training else torch.ones_like(layers)
    act_bytes = (mult * act_layers.double() * T["abps"] * T["seq"].clamp(min=1)
                 / mp / T["sp"])

    kv_bytes = torch.zeros_like(resident)
    if not mem.training:
        kv = T["kv_layer"]
        kv_bytes = torch.where(kv != 0.0, kv * T["samples"] * layers / mp, 0.0)
    total = weight_bytes + grad_bytes + opt_bytes + act_bytes + kv_bytes
    return _to_host((total,), copies)[0]


def feasible_batch(batch: Union[CandidateBatch, Sequence[Workload]],
                   mem: MemoryModel, device=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(memory_bytes_per_npu, feasible) arrays for a candidate batch —
    the sweep masks infeasible points on these before any cost math."""
    mem_bytes = memory_bytes_batch(batch, mem, device=device)
    return mem_bytes, mem_bytes <= mem.npu_hbm_bytes
