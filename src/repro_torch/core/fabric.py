"""FRED wafer-scale fabric: 2-level almost-fat-tree of FRED switches
(paper Sec. VI, Fig. 8) and the four evaluation configs of Table IV.

The PyTorch port's own copy of ``repro.core.fabric``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

Topology is parameterized: ``n_groups`` L1 groups of ``group_size`` NPUs,
plus ``n_io`` I/O controllers spread across L1 switches; L2 spine connects
L1s.  The paper's wafer is the default shape (5 groups of 4, 18 I/O).
Almost-fat-tree: L1→L2 BW sums the *NPU* bandwidth only (I/O flows are
bottlenecked by the 128 GB/s controllers anyway).

Effective-bandwidth model: for a collective over ``group`` with in-network
execution the per-NPU injection traffic is D (vs 2(n−1)/n·D endpoint); the
sustained rate is the bottleneck of NPU→L1 BW and the per-flow share of
L1→L2 BW — reproducing the paper's Sec. VIII microbenchmark numbers
(1875 GB/s FRED-A, 3 TB/s FRED-C/D wafer-wide, 375 GB/s FRED-A DP, ...).

HW accounting (Table III) is likewise derived from the shape: every L1
switch is a FRED_3 with ``group_size`` NPU ports + its share of the I/O
ports + uplink ports; the L2 spine switch aggregates the uplinks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .defects import DefectMask, normalize
from .flows import endpoint_traffic_bytes, innetwork_traffic_bytes


@dataclasses.dataclass
class FredConfig:
    name: str
    npu_l1_bw: float            # per-NPU link to its L1 switch (B/s, one dir)
    l1_l2_bw: float             # per-L1-switch uplink to the L2 spine
    in_network: bool
    io_bw: float = 128e9
    switch_latency: float = 20e-9     # repro: unit[s]
    step_overhead: float = 4e-7       # repro: unit[s] per flow-step (single fabric
                                      # traversal; no multi-hop protocol)


# Table IV configurations: the paper's modelled FRED fabric bandwidths, inputs
# of the simulated wafer, not rates of the card this code runs on
FRED_A = FredConfig("FRED-A", npu_l1_bw=3e12, l1_l2_bw=1.5e12, in_network=False)
FRED_B = FredConfig("FRED-B", npu_l1_bw=3e12, l1_l2_bw=1.5e12, in_network=True)
FRED_C = FredConfig("FRED-C", npu_l1_bw=3e12, l1_l2_bw=12e12, in_network=False)
FRED_D = FredConfig("FRED-D", npu_l1_bw=3e12, l1_l2_bw=12e12, in_network=True)

CONFIGS = {c.name: c for c in (FRED_A, FRED_B, FRED_C, FRED_D)}


@dataclasses.dataclass
class FredFabric:
    config: FredConfig
    n_groups: int = 5                 # L1 switches
    group_size: int = 4               # NPUs per L1 switch
    n_io: int = 18                    # I/O controllers, spread across L1s
    defects: Optional[DefectMask] = None

    def __post_init__(self):
        if self.n_groups < 1 or self.group_size < 1:
            raise ValueError(f"fabric needs positive shape, got "
                             f"{self.n_groups} groups of {self.group_size}")
        self.defects = normalize(self.defects)

    @property
    def n_npus(self) -> int:
        return self.n_groups * self.group_size

    @property
    def n_healthy(self) -> int:
        return (self.n_npus if self.defects is None
                else self.defects.n_healthy)

    def healthy_npus(self) -> List[int]:
        if self.defects is None:
            return list(range(self.n_npus))
        return list(self.defects.healthy())

    @property
    def npus_per_l1(self) -> int:
        return self.group_size

    @property
    def n_l1(self) -> int:
        return self.n_groups

    @property
    def bisection(self) -> float:
        """Full-duplex spine bisection-cut bandwidth.

        Splitting the NPUs into two halves of L1 groups severs the smaller
        half's uplinks — ``n_groups // 2`` links — counted in both
        directions, consistent with :meth:`MeshFabric.bisection_bw`'s
        ``2 · (links crossing the cut) · link_bw`` definition.  (The seed
        formula ``n_groups · l1_l2_bw / 2 * 2`` let the halving cancel and
        double-counted the cut by one uplink per *group*.)"""
        return 2 * (self.n_groups // 2) * self.config.l1_l2_bw

    def bisection_bw(self) -> float:
        """Alias matching :meth:`MeshFabric.bisection_bw`."""
        return self.bisection

    def l1_of(self, nid: int) -> int:
        return nid // self.group_size

    def io_per_group(self) -> List[int]:
        """I/O controllers per L1 switch, spread as evenly as possible
        (paper: 18 over 5 L1s → 4,4,4,3,3)."""
        base, extra = divmod(self.n_io, self.n_groups)
        return [base + (g < extra) for g in range(self.n_groups)]

    # ---- effective bandwidth --------------------------------------------------
    def _group_l1_span(self, group: Sequence[int]) -> Dict[int, int]:
        span: Dict[int, int] = {}
        for nid in group:
            l1 = self.l1_of(nid)
            span[l1] = span.get(l1, 0) + 1
        return span

    def span_structure(self, group: Sequence[int]) -> Tuple[int, int]:
        """(g, k) = (#L1 switches spanned, max members under one L1) —
        the only group-dependent structure :meth:`collective_time` and
        :meth:`effective_npu_bw` consume.  The batched sweep engine
        (core/batch_engine.py) memoizes this per distinct group pattern
        and vectorizes the remaining pure arithmetic."""
        span = self._group_l1_span(group)
        if not span:
            return 1, 1
        return len(span), max(span.values())

    def effective_npu_bw(self, group: Sequence[int],
                         concurrent_groups: int = 1) -> float:
        """Sustained per-NPU injection BW for one collective flow.

        * group under one L1 → full NPU-L1 BW.
        * group spanning L1s, endpoint hierarchical algorithm → the upper
          ring runs at the per-NPU share of L1→L2 (paper: local phase at
          3 TB/s contributes; effective = share + (k−1)·share for k NPUs
          per L1 — i.e. the Sec. VIII '375 + 4×375 = 1875 GB/s' analysis).
        * in-network → L1 reduces first; each NPU effectively drives
          min(NPU-L1, L1-L2) for its (halved) traffic.
        """
        cfg = self.config
        span = self._group_l1_span(group)
        if len(span) <= 1:
            return cfg.npu_l1_bw
        k = max(span.values())                    # NPUs of this group per L1
        l2_bw = cfg.l1_l2_bw
        f = self.uplink_factor(group)
        if f != 1.0:                   # severed uplinks shrink the spine BW;
            l2_bw = cfg.l1_l2_bw * f   # defect-free path stays byte-for-byte
        # L1→L2 BW shared by concurrent flows crossing the spine
        share = l2_bw / max(k * concurrent_groups, 1)
        if cfg.in_network:
            return min(cfg.npu_l1_bw,
                       l2_bw / max(concurrent_groups, 1))
        # hierarchical endpoint: the local phase at npu_l1_bw amplifies the
        # spine-limited phase by the local fan-in — the paper's Sec. VIII
        # '375 + 4·375 = 1875 GB/s' analysis, i.e. share·(1+k) when several
        # group members share an L1
        if k > 1:
            return min(cfg.npu_l1_bw, share * (1 + k))
        return min(cfg.npu_l1_bw, share)

    def collective_time(self, kind: str, group: Sequence[int], nbytes: float,
                        concurrent_groups: int = 1) -> float:
        """Step-explicit collective time.

        In-network: one injection of the (≈halved) traffic through the
        reduction/distribution tree — 4 fabric traversals (NPU→L1→L2→L1→NPU)
        regardless of n (this is FRED's latency win over 2(n−1) ring steps).
        Endpoint (FRED-A/C): hierarchical two-phase ring — 2(k−1) local +
        2(g−1) spine steps."""
        n = len(group)
        if n <= 1 or nbytes <= 0:
            return 0.0
        cfg = self.config
        span = self._group_l1_span(group)
        g, k = len(span), max(span.values())
        if cfg.in_network:
            traffic = innetwork_traffic_bytes(kind, n, nbytes)
            steps = 4 if g > 1 else 2
        else:
            traffic = endpoint_traffic_bytes(kind, n, nbytes)
            steps = (2 * (k - 1) + 2 * (g - 1)) if g > 1 else 2 * (n - 1)
            steps = max(steps, 2)
            if kind != "all_reduce":
                steps = max(steps // 2, 1)
        bw = self.effective_npu_bw(group, concurrent_groups)
        per_step = (traffic / max(steps, 1)) / bw + cfg.switch_latency +             cfg.step_overhead
        return steps * per_step

    def pp_transfer_time(self, nbytes: float) -> float:
        """Peer NPUs sit under one L1: full NPU-L1 BW (Sec. VIII)."""
        return nbytes / self.config.npu_l1_bw

    # ---- I/O -------------------------------------------------------------------
    def io_linerate_factor(self) -> float:
        """FRED routes I/O streams through the tree without hotspots —
        full line rate (Sec. III Metric 1)."""
        return 1.0

    def io_stream_rate(self, n_io: "int | None" = None) -> float:
        return (self.n_io if n_io is None else n_io) * self.config.io_bw

    def uplink_factor(self, group: Sequence[int]) -> float:
        """Fraction of L1→L2 bandwidth surviving the defect mask for this
        group: min over spanned L1s of healthy/total uplinks.  1.0 with no
        mask (or no severed uplinks); at least one uplink per L1 is assumed
        alive (a fully severed L1 is an unplaceable dead group).  NPU→L1
        links are identified with their NPU (core/defects.py), so they
        never show up here."""
        d = self.defects
        if d is None or not d.dead_uplinks:
            return 1.0
        up = self.uplinks_per_l1()
        f = 1.0
        for l1 in self._group_l1_span(group):
            if l1 < self.n_groups:
                healthy = max(1, up - d.dead_uplinks_of(l1))
                f = min(f, healthy / up)
        return f

    # ---- Table III HW accounting (derived from the shape) ----------------------
    def uplinks_per_l1(self) -> int:
        """Physical uplink ports per L1 switch, at NPU-port width."""
        return max(1, math.ceil(self.config.l1_l2_bw / self.config.npu_l1_bw))

    def switch_inventory(self) -> List[Tuple[str, int, int]]:
        """(level, ports, count) of the FRED switches this shape needs.

        L1 switches carry ``group_size`` NPU ports, their share of the I/O
        controllers, and the spine uplinks; the L2 spine switch aggregates
        every L1's uplinks.  L1s with different I/O shares are distinct
        port counts (the paper's FRED3(12)/FRED3(11) split on the default
        wafer)."""
        up = self.uplinks_per_l1()
        by_ports: Dict[int, int] = {}
        for io in self.io_per_group():
            p = self.group_size + io + up
            by_ports[p] = by_ports.get(p, 0) + 1
        inv = [("L1", p, c) for p, c in sorted(by_ports.items(), reverse=True)]
        inv.append(("L2", max(self.n_groups * up, 2), 1))
        return inv

    def hw_accounting(self, m: int = 3) -> Dict[str, float]:
        """Aggregate area/power/µswitch count over the derived inventory
        (FRED_m switches; paper Table III models m=3)."""
        from .switch import FredSwitch, hw_overhead
        total = {"area_mm2": 0.0, "power_w": 0.0, "microswitches": 0,
                 "switches": 0}
        for _level, ports, count in self.switch_inventory():
            o = hw_overhead(FredSwitch.build(ports, m))
            total["area_mm2"] += count * o["area_mm2"]
            total["power_w"] += count * o["power_w"]
            total["microswitches"] += count * o["microswitches"]
            total["switches"] += count
        return total
