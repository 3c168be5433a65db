"""Conflict-free collective routing on a FRED switch (paper Sec. V-B/C).

The PyTorch port's own copy of ``repro.core.routing``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_decide.py`` holds
its results equal to the original's.

Routing treats a *flow* as the unit: flows that share an input or output
µswitch must traverse different middle-stage subnetworks.  The protocol:

  1. Build the conflict graph (node = flow, edge = shared input/output
     µswitch).
  2. Color it with m colors (m = number of middle subnetworks).  We use
     greedy (largest-degree-first) with backtracking up to a node budget —
     the paper computes routes at compile time and stores them in the
     switch control unit, so routing cost is off the critical path.
  3. Activate reduction on input µswitches whose both ports belong to one
     flow; distribution on output µswitches whose both ports belong to one
     flow.
  4. Recurse into each middle subnetwork with the flows assigned to it
     (port ids remapped to the subnetwork's ports).

Failure to color ⇒ *routing conflict* (Fig. 7(j): four specific flows on
FRED_2(8) cannot route; FRED_3(8) routes them).  The caller picks one of
the paper's four mitigations; FRED itself uses m=3 + placement (Sec. V-C).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .flows import Flow
from .switch import FredSwitch


class RoutingConflict(Exception):
    """Raised when the conflict graph is not m-colorable."""

    def __init__(self, flows, level: int):
        self.flows = flows
        self.level = level
        super().__init__(
            f"routing conflict among {len(flows)} flows at recursion "
            f"level {level}")


@dataclasses.dataclass
class RoutingAssignment:
    """Result of routing one level of the switch."""
    colors: Dict[Flow, int]                  # flow → middle subnetwork
    reduce_at: List[Tuple[int, Flow]]        # input µswitch idx, flow
    distribute_at: List[Tuple[int, Flow]]    # output µswitch idx, flow
    sub_assignments: List["RoutingAssignment"]


def conflict_graph(switch: FredSwitch, flows: Sequence[Flow]
                   ) -> Dict[Flow, set]:
    """Edges between flows sharing an input or output µswitch.

    Two ports of the *same* flow sharing a µswitch is not a conflict —
    that is exactly where reduction/distribution activates."""
    adj: Dict[Flow, set] = {f: set() for f in flows}
    for a, b in itertools.combinations(flows, 2):
        shared = False
        ia = {switch.input_switch_of(p) for p in a.ips} - {None}
        ib = {switch.input_switch_of(p) for p in b.ips} - {None}
        if ia & ib:
            shared = True
        oa = {switch.output_switch_of(p) for p in a.ops} - {None}
        ob = {switch.output_switch_of(p) for p in b.ops} - {None}
        if oa & ob:
            shared = True
        if shared:
            adj[a].add(b)
            adj[b].add(a)
    return adj


def color_graph(adj: Dict[Flow, set], m: int,
                max_backtrack: int = 200_000) -> Optional[Dict[Flow, int]]:
    """m-coloring: greedy largest-degree-first, then backtracking."""
    nodes = sorted(adj, key=lambda f: (-len(adj[f]), sorted(f.ips)))
    colors: Dict[Flow, int] = {}

    # greedy first — succeeds for almost all training communication sets
    ok = True
    for nd in nodes:
        used = {colors[nb] for nb in adj[nd] if nb in colors}
        free = [c for c in range(m) if c not in used]
        if not free:
            ok = False
            break
        colors[nd] = free[0]
    if ok:
        return colors

    # full backtracking (bounded)
    colors = {}
    budget = [max_backtrack]

    def bt(i: int) -> bool:
        if budget[0] <= 0:
            return False
        if i == len(nodes):
            return True
        nd = nodes[i]
        used = {colors[nb] for nb in adj[nd] if nb in colors}
        for c in range(m):
            if c in used:
                continue
            colors[nd] = c
            budget[0] -= 1
            if bt(i + 1):
                return True
            del colors[nd]
        return False

    return dict(colors) if bt(0) else None


def _remap_flow(switch: FredSwitch, f: Flow) -> Flow:
    """Map a flow's ports onto the middle subnetwork's port ids."""
    return Flow(frozenset(switch.middle_port_of(p) for p in f.ips),
                frozenset(switch.middle_port_of(p) for p in f.ops),
                f.bytes, f.tag)


def route(switch: FredSwitch, flows: Sequence[Flow], *, level: int = 0
          ) -> RoutingAssignment:
    """Recursively route ``flows``; raises RoutingConflict on failure."""
    flows = [f for f in flows if f.ips or f.ops]
    if switch.is_base or not flows:
        return RoutingAssignment(colors={f: 0 for f in flows},
                                 reduce_at=[], distribute_at=[],
                                 sub_assignments=[])

    adj = conflict_graph(switch, flows)
    colors = color_graph(adj, switch.m)
    if colors is None:
        raise RoutingConflict(flows, level)

    reduce_at, distribute_at = [], []
    for f in flows:
        by_in: Dict[int, int] = {}
        for p in f.ips:
            sw = switch.input_switch_of(p)
            if sw is not None:
                by_in[sw] = by_in.get(sw, 0) + 1
        for sw, cnt in by_in.items():
            if cnt == 2 and switch.input_switches[sw].can_reduce:
                reduce_at.append((sw, f))
        by_out: Dict[int, int] = {}
        for p in f.ops:
            sw = switch.output_switch_of(p)
            if sw is not None:
                by_out[sw] = by_out.get(sw, 0) + 1
        for sw, cnt in by_out.items():
            if cnt == 2 and switch.output_switches[sw].can_distribute:
                distribute_at.append((sw, f))

    subs = []
    for mid_idx, mid in enumerate(switch.middles):
        assigned = [_remap_flow(switch, f) for f, c in colors.items()
                    if c == mid_idx]
        subs.append(route(mid, assigned, level=level + 1))
    return RoutingAssignment(colors=colors, reduce_at=reduce_at,
                             distribute_at=distribute_at,
                             sub_assignments=subs)


def routable(switch: FredSwitch, flows: Sequence[Flow]) -> bool:
    try:
        route(switch, flows)
        return True
    except RoutingConflict:
        return False


def strategy_routable(strategy, shape, m: int = 3,
                      uplinks: Optional[int] = None,
                      defects=None) -> bool:
    """True iff every parallelism phase of ``strategy`` routes conflict-free
    under the MP-consecutive placement.

    ``shape`` is either an int — the legacy single-crossbar check on one
    FRED_m(n_ports) switch — or the actual fabric shape ``(n_groups,
    group_size)``, in which case the check is hierarchical and shape-aware:
    each L1 switch routes its local flow segments (local NPU ports, plus an
    uplink port for flows spanning other groups, assigned round-robin over
    the ``uplinks`` physical uplink ports — pass
    :meth:`FredFabric.uplinks_per_l1`; defaults to ``group_size``, the
    almost-fat-tree upper bound) on a FRED_m(group_size+uplinks) switch,
    and the L2 spine routes the group-spanning flows over every L1's
    uplink ports.  Flows of ONE parallelism type run at a time (they occur
    in different phases of the training step — Sec. III Metric 4).

    ``defects`` (a :class:`~repro_torch.core.defects.DefectMask`) re-runs the
    whole check under the mask's compacted placement: flows take the
    *healthy* NPU ports (never a dead one), and spanning flows only get a
    surviving uplink's port per L1 — a strategy that needs more workers
    than healthy NPUs (or more spanning flows than surviving uplinks can
    take conflict-free) is simply not routable."""
    from .defects import normalize
    from .flows import all_reduce
    from .placement import (defect_placement, fred_placement,
                            placement_groups)

    defects = normalize(defects)
    if isinstance(shape, tuple):
        return _shape_routable(strategy, shape[0], shape[1], m,
                               uplinks=uplinks, defects=defects)
    n_ports = shape
    if strategy.n_workers > n_ports:
        return False
    if defects is not None and strategy.n_workers > defects.n_healthy:
        return False
    if strategy.n_workers < 2:
        return True
    sw = FredSwitch.build(max(n_ports, 2), m)
    pl = (fred_placement(strategy, n_ports) if defects is None
          else defect_placement(strategy, defects, n_ports))
    groups = placement_groups(strategy, pl)
    for kind in ("mp", "dp", "pp"):
        flows = [all_reduce(g)[0][0] for g in groups[kind] if len(g) > 1]
        if flows and not routable(sw, flows):
            return False
    return True


def _shape_routable(strategy, n_groups: int, group_size: int,
                    m: int = 3, uplinks: Optional[int] = None,
                    defects=None) -> bool:
    """Hierarchical routability on an (n_groups, group_size) FRED fabric:
    per-L1 routing of local flow segments, then L2-spine routing of the
    spanning flows.  Each L1 exposes ``uplinks`` physical uplink ports;
    spanning flows are assigned uplinks round-robin per L1 (the compile-
    time router is free to pick, round-robin is its canonical choice).
    A defect mask compacts the placement onto healthy NPUs and removes
    each L1's dead uplink ports from the round-robin pool."""
    from .placement import defect_placement, fred_placement, placement_groups

    n = n_groups * group_size
    if strategy.n_workers > n:
        return False
    if defects is not None and strategy.n_workers > defects.n_healthy:
        return False
    if strategy.n_workers < 2:
        return True
    up = uplinks if uplinks is not None else group_size
    up = max(1, up)
    live_up = [up] * n_groups
    if defects is not None:
        live_up = [max(1, up - defects.dead_uplinks_of(l1))
                   for l1 in range(n_groups)]
    pl = (fred_placement(strategy, n) if defects is None
          else defect_placement(strategy, defects, n))
    groups = placement_groups(strategy, pl)
    l1_switch = FredSwitch.build(max(group_size + up, 2), m)
    spine = FredSwitch.build(max(n_groups * up, 2), m)
    for kind in ("mp", "dp", "pp"):
        colls = [cg for cg in groups[kind] if len(cg) > 1]
        if not colls:
            continue
        # uplink assignment: per L1, spanning flows take uplink ports
        # round-robin in enumeration order
        upidx: Dict[Tuple[int, int], int] = {}    # (l1, flow idx) → uplink
        counters = [0] * n_groups
        for ci, cg in enumerate(colls):
            l1s = sorted({nid // group_size for nid in cg})
            if len(l1s) < 2:
                continue
            for l1 in l1s:
                upidx[(l1, ci)] = counters[l1] % live_up[l1]
                counters[l1] += 1
        for l1 in range(n_groups):
            local_flows = []
            for ci, cg in enumerate(colls):
                local = [nid - l1 * group_size for nid in cg
                         if nid // group_size == l1]
                if not local:
                    continue
                ports = list(local)
                if (l1, ci) in upidx:             # spans other L1s
                    ports.append(group_size + upidx[(l1, ci)])
                if len(ports) >= 2:
                    local_flows.append(
                        Flow.make(ports, ports, tag=f"{kind}{ci}"))
            if local_flows and not routable(l1_switch, local_flows):
                return False
        spine_flows = []
        for ci, cg in enumerate(colls):
            ports = sorted(l1 * up + idx for (l1, c), idx in upidx.items()
                           if c == ci)
            if len(ports) > 1:
                spine_flows.append(
                    Flow.make(ports, ports, tag=f"{kind}{ci}"))
        if spine_flows and not routable(spine, spine_flows):
            return False
    return True


# --------------------------------------------------------------------------
# the paper's Fig. 7(j) example
# --------------------------------------------------------------------------

def fig7j_flows() -> List[Flow]:
    """Four flows with circular µswitch dependencies among flows 0,1,2:
    not routable on FRED_2(8), routable on FRED_3(8) (footnote 4)."""
    return [
        Flow.make([0, 2], [0, 2], tag="f0"),
        Flow.make([1, 4], [1, 4], tag="f1"),
        Flow.make([3, 5], [3, 5], tag="f2"),
        Flow.make([6, 7], [6, 7], tag="f3"),
    ]
