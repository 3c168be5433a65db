"""Baseline wafer-scale 2D-mesh network model (paper Sec. III, VI-B2).

The PyTorch port's own copy of ``repro.core.meshnet``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

``rows``×``cols`` mesh of NPUs (paper evaluates 5×4), 750 GB/s per link per
direction, X-Y routing, I/O controllers (128 GB/s CXL) attached to border
NPUs (corners get two, or an explicit ``n_io`` override).
Collectives use logical rings over the member NPUs routed X-Y, except the
wafer-wide All-Reduce which uses the hierarchical 2D algorithm with two
reverse-direction chunks [Kumar & Jouppi 2020] (Sec. VII-B).

The model exposes:
  * ``xy_links``           — links crossed between two NPUs under X-Y.
  * ``ring_max_congestion``— worst per-link overlap for a set of rings.
  * ``collective_time``    — endpoint-algorithm time for one collective.
  * ``io_linerate_factor`` — Fig. 4's (2N−1)·P hotspot analysis: the factor
                             by which I/O streams must be slowed so the
                             hotspot link sustains all channels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .defects import DefectMask, normalize

Link = Tuple[Tuple[int, int], Tuple[int, int]]   # ((r,c) -> (r,c))


def strided_ring_family(healthy: Sequence[int], count: int, stride: int,
                        n_used: int) -> List[List[int]]:
    """All concurrent rings of one strided-group pattern, materialized on
    the ``healthy`` id list.

    Under the canonical placements every collective of one parallelism
    axis is a family of arithmetic progressions over the first ``n_used``
    healthy NPUs, fully determined by ``(count, stride, n_used)``: ring
    ``(blk, r)`` holds ``healthy[blk·count·stride + r + i·stride]`` for
    ``i < count`` — MP groups are ``(mp, 1)`` blocks, DP groups
    ``(dp_per_wafer, mp·pp)`` interleaves, EP groups ``(ep, mp·pp)``
    interleaved blocks.  ``family[0]`` is always the representative group
    the scalar simulator evaluates, so feeding the whole family to
    :meth:`MeshFabric.collective_time` as ``concurrent_rings`` charges the
    evaluated ring the *real* shared-link congestion its siblings' detour
    paths create under a defect mask (healthy meshes keep the
    single-ring model — disjoint X-Y rings never detour onto each other).
    Degenerate patterns (``count ≤ 1`` or a block wider than ``n_used``)
    fall back to the single representative ring."""
    block = count * stride
    if count <= 1 or block <= 0 or block > n_used:
        return [[healthy[i * stride] for i in range(max(count, 1))]]
    return [[healthy[blk * block + r + i * stride] for i in range(count)]
            for blk in range(n_used // block)
            for r in range(stride)]


@dataclasses.dataclass
class MeshFabric:
    rows: int = 5
    cols: int = 4
    # the paper's modelled mesh (Sec. VI-B2), not rates of the card this
    # code runs on
    link_bw: float = 750e9            # B/s per direction
    io_bw: float = 128e9              # per I/O controller
    latency_per_hop: float = 20e-9    # repro: unit[s]
    step_overhead: float = 8e-7       # repro: unit[s] per ring-step SW/protocol
                                      # (ASTRA-SIM-style NPU processing delay)
    n_io: Optional[int] = None        # None → derived border placement
    defects: Optional[DefectMask] = None

    def __post_init__(self):
        if self.rows < 1 or self.cols < 1:
            raise ValueError(f"mesh needs positive dims, got "
                             f"{self.rows}x{self.cols}")
        self.defects = normalize(self.defects)

    @property
    def n(self) -> int:
        return self.rows * self.cols

    @property
    def n_npus(self) -> int:
        """Alias of :attr:`n` — uniform NPU-count accessor across fabric
        types (FredFabric, WaferCluster expose the same name)."""
        return self.n

    def corner_degree(self) -> int:
        """Links at a corner NPU — the wafer-wide All-Reduce bottleneck
        (2 on a proper 2D mesh, 1 on a degenerate 1×N line)."""
        return max((self.rows > 1) + (self.cols > 1), 1)

    def coord(self, nid: int) -> Tuple[int, int]:
        return divmod(nid, self.cols)

    def degree(self, nid: int) -> int:
        r, c = self.coord(nid)
        return ((r > 0) + (r < self.rows - 1) +
                (c > 0) + (c < self.cols - 1))

    def border_npus(self) -> List[int]:
        out = []
        for nid in range(self.n):
            r, c = self.coord(nid)
            if r in (0, self.rows - 1) or c in (0, self.cols - 1):
                out.append(nid)
        return out

    def n_io_controllers(self) -> int:
        """Border NPUs get one controller; corners two (paper: 18 on 5×4).
        An explicit ``n_io`` overrides the derived placement."""
        if self.n_io is not None:
            return self.n_io
        total = 0
        for nid in self.border_npus():
            r, c = self.coord(nid)
            corner = (r in (0, self.rows - 1)) and (c in (0, self.cols - 1))
            total += 2 if corner else 1
        return total

    @property
    def n_healthy(self) -> int:
        return self.n if self.defects is None else self.defects.n_healthy

    def healthy_npus(self) -> List[int]:
        if self.defects is None:
            return list(range(self.n))
        return list(self.defects.healthy())

    # ---- routing -------------------------------------------------------------
    def xy_links(self, src: int, dst: int) -> List[Link]:
        (r0, c0), (r1, c1) = self.coord(src), self.coord(dst)
        links: List[Link] = []
        c = c0
        while c != c1:
            nc = c + (1 if c1 > c else -1)
            links.append(((r0, c), (r0, nc)))
            c = nc
        r = r0
        while r != r1:
            nr = r + (1 if r1 > r else -1)
            links.append(((r, c1), (nr, c1)))
            r = nr
        return links

    def _yx_links(self, src: int, dst: int) -> List[Link]:
        """Y-then-X dimension order — the first detour tried under defects."""
        (r0, c0), (r1, c1) = self.coord(src), self.coord(dst)
        links: List[Link] = []
        r = r0
        while r != r1:
            nr = r + (1 if r1 > r else -1)
            links.append(((r, c0), (nr, c0)))
            r = nr
        c = c0
        while c != c1:
            nc = c + (1 if c1 > c else -1)
            links.append(((r1, c), (r1, nc)))
            c = nc
        return links

    def _link_healthy(self, ln: Link) -> bool:
        if self.defects is None:
            return True
        (r0, c0), (r1, c1) = ln
        return not self.defects.link_dead(r0 * self.cols + c0,
                                          r1 * self.cols + c1)

    def route_links(self, src: int, dst: int) -> List[Link]:
        """Links crossed src→dst, avoiding dead links/NPUs when a
        :class:`DefectMask` is set: X-Y first (the healthy-path fast case),
        then the Y-X detour, then a deterministic BFS over healthy links.
        A dead NPU's router is dead too, so no path may cross it.
        Raises ``ValueError`` when an endpoint is dead or the healthy
        sub-mesh is disconnected."""
        if self.defects is None:
            return self.xy_links(src, dst)
        for nid in (src, dst):
            if self.defects.npu_dead(nid):
                raise ValueError(f"route endpoint NPU {nid} is dead")
        for path in (self.xy_links(src, dst), self._yx_links(src, dst)):
            if all(self._link_healthy(ln) for ln in path):
                return path
        # BFS over the healthy sub-mesh (deterministic neighbour order)
        parent: Dict[int, int] = {src: src}
        frontier = [src]
        while frontier and dst not in parent:
            nxt: List[int] = []
            for nid in frontier:
                r, c = self.coord(nid)
                for nb in ((nid + 1) if c + 1 < self.cols else -1,
                           (nid - 1) if c > 0 else -1,
                           (nid + self.cols) if r + 1 < self.rows else -1,
                           (nid - self.cols) if r > 0 else -1):
                    if nb < 0 or nb in parent:
                        continue
                    if self.defects.link_dead(nid, nb):
                        continue
                    parent[nb] = nid
                    nxt.append(nb)
            frontier = nxt
        if dst not in parent:
            raise ValueError(
                f"no healthy mesh path {src}->{dst} under defect mask")
        ids = [dst]
        while ids[-1] != src:
            ids.append(parent[ids[-1]])
        ids.reverse()
        return [(self.coord(a), self.coord(b)) for a, b in zip(ids, ids[1:])]

    def _path_links(self, src: int, dst: int) -> List[Link]:
        return (self.xy_links(src, dst) if self.defects is None
                else self.route_links(src, dst))

    def ring_max_congestion(self, rings: Sequence[Sequence[int]]) -> int:
        """Max number of ring edges (over all rings) crossing any one link."""
        load: Dict[Link, int] = {}
        for ring in rings:
            n = len(ring)
            if n < 2:
                continue
            for i in range(n):
                a, b = ring[i], ring[(i + 1) % n]
                for ln in self._path_links(a, b):
                    load[ln] = load.get(ln, 0) + 1
        return max(load.values()) if load else 0

    # ---- collectives -----------------------------------------------------------
    def bisection_bw(self) -> float:
        """Full-duplex bisection: cutting the longer dimension in half
        crosses min(rows, cols) links (4 × 750 GB/s × 2 on the 5×4 wafer)."""
        return 2 * min(self.rows, self.cols) * self.link_bw

    def wafer_wide_allreduce_bw(self) -> float:
        """Hierarchical 2D algorithm, 2 reverse chunks: bounded by corner
        NPUs ⇒ per-NPU effective BW = corner_degree·link_bw — 2·750 GB/s
        on any proper 2D mesh (Sec. VIII)."""
        return self.corner_degree() * self.link_bw

    def _ring_hops(self, ring: Sequence[int]) -> float:
        """Mean X-Y hop count between ring neighbours."""
        n = len(ring)
        if n < 2:
            return 1.0
        tot = sum(len(self._path_links(ring[i], ring[(i + 1) % n]))
                  for i in range(n))
        return max(tot / n, 1.0)

    def ring_structure(self, group: Sequence[int]) -> Tuple[int, float]:
        """(congestion, mean hops) of the single logical ring over
        ``group`` — the exact structural inputs :meth:`collective_time`
        derives for its non-wafer-wide branch (``cong`` already floored
        at 1).  Pure integer/ratio topology quantities, independent of
        payload size and step overheads; the batched sweep engine
        (core/batch_engine.py) computes them once per distinct group
        pattern and then evaluates every strategy's times as array ops.

        Implemented as a single integer-keyed pass over the ring's X-Y
        unit links (directed, X before Y — the same walk
        :meth:`xy_links` materializes as tuple paths), hot enough in
        500+-NPU sweeps that the tuple allocations mattered; equivalence
        with ``ring_max_congestion`` + ``_ring_hops`` is pinned in
        tests/test_batch_engine.py."""
        ring = list(group)
        n = len(ring)
        if n < 2:
            return 1, 1.0
        if self.defects is not None:
            # defect-aware (detoured) paths: generic directed-link walk —
            # the same quantities ring_max_congestion + _ring_hops derive
            load2: Dict[Link, int] = {}
            tot2 = 0
            for i in range(n):
                path = self.route_links(ring[i], ring[(i + 1) % n])
                tot2 += len(path)
                for ln in path:
                    load2[ln] = load2.get(ln, 0) + 1
            cong2 = max(load2.values()) if load2 else 0
            return max(cong2, 1), max(tot2 / n, 1.0)
        C = self.cols
        base_v = 2 * self.rows * C           # separate id space for Y links
        load: Dict[int, int] = {}
        tot = 0
        for i in range(n):
            (r0, c0) = divmod(ring[i], C)
            (r1, c1) = divmod(ring[(i + 1) % n], C)
            if c1 > c0:                      # X first, heading right
                for c in range(c0, c1):
                    key = (r0 * C + c) * 2
                    load[key] = load.get(key, 0) + 1
                tot += c1 - c0
            elif c0 > c1:                    # heading left
                for c in range(c1, c0):
                    key = (r0 * C + c) * 2 + 1
                    load[key] = load.get(key, 0) + 1
                tot += c0 - c1
            if r1 > r0:                      # then Y along column c1, down
                for r in range(r0, r1):
                    key = base_v + (r * C + c1) * 2
                    load[key] = load.get(key, 0) + 1
                tot += r1 - r0
            elif r0 > r1:                    # up
                for r in range(r1, r0):
                    key = base_v + (r * C + c1) * 2 + 1
                    load[key] = load.get(key, 0) + 1
                tot += r0 - r1
        cong = max(load.values()) if load else 0
        return max(cong, 1), max(tot / n, 1.0)

    def collective_time(self, kind: str, group: Sequence[int], nbytes: float,
                        concurrent_rings: Sequence[Sequence[int]] = ()
                        ) -> float:
        """Endpoint ring algorithm over ``group``, step-explicit.

        Ring All-Reduce = 2(n−1) serialized steps, each moving a D/n chunk
        over (possibly multi-hop, possibly congested) X-Y paths.  This is
        what makes per-layer collectives on the mesh *latency-bound* — the
        effect FRED's single-injection in-network trees eliminate; the
        wafer-wide case uses the hierarchical-2D algorithm with 2 reverse
        chunks, whose step count is (rows−1)+(cols−1) per phase.
        """
        from .flows import endpoint_traffic_bytes
        n = len(group)
        if n <= 1 or nbytes <= 0:
            return 0.0
        traffic = endpoint_traffic_bytes(kind, n, nbytes)
        if n == self.n and self.defects is None:
            # hierarchical 2D: row rings then column rings, 2 chunks
            # (requires the full defect-free rectangle — any hole or dead
            # link degrades to the generic ring branch below)
            bw = self.wafer_wide_allreduce_bw()
            steps = 2 * ((self.cols - 1) + (self.rows - 1))
            if kind != "all_reduce":
                steps //= 2
            hops = 1.0
        else:
            rings = list(concurrent_rings) or [list(group)]
            cong = max(self.ring_max_congestion(rings), 1)
            bw = self.link_bw / cong
            steps = 2 * (n - 1) if kind == "all_reduce" else (n - 1)
            hops = self._ring_hops(list(group))
        chunk = traffic / max(steps, 1)
        per_step = (chunk / bw + self.latency_per_hop * hops +
                    self.step_overhead)
        return steps * per_step

    def pp_transfer_time(self, nbytes: float) -> float:
        """Border-to-next-stage multicast: one link (Sec. VIII)."""
        return nbytes / self.link_bw

    # ---- Fig. 4: I/O hotspot ----------------------------------------------------
    def io_hotspot_load(self) -> float:
        """Required hotspot-link BW (in units of per-channel rate P) for
        all I/O channels streaming a broadcast simultaneously: (2N−1) for an
        N×N mesh (paper's formula; for rectangular meshes use the max
        dimension)."""
        n = max(self.rows, self.cols)
        return 2 * n - 1

    def io_linerate_factor(self) -> float:
        """Fraction of I/O line rate sustainable through the hotspot link:
        min(1, link_bw / ((2N−1)·P)) — GPT-3 case: 750/1152 = 0.65."""
        need = self.io_hotspot_load() * self.io_bw
        return min(1.0, self.link_bw / need)

    def io_stream_rate(self) -> float:
        """Aggregate sustainable I/O streaming rate onto the wafer."""
        return self.n_io_controllers() * self.io_bw * self.io_linerate_factor()
