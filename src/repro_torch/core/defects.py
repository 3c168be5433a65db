"""Defect masks: dead NPUs / dead links on a wafer, with seedable samplers.

The PyTorch port's own copy of ``repro.core.defects``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

Wafer-scale parts ship with manufacturing defects (the yield argument of
Hecaton / Wafer-on-Wafer hybrid bonding); a :class:`DefectMask` is the
repo-wide description of one defect draw.  The mask lives in the *NPU id
space* of a single wafer and every fabric interprets the parts of it that
exist on that fabric:

  * ``dead_npus`` — NPU ids that are unusable.  All fabrics honour these;
    placement compacts logical workers onto the healthy ids
    (``core/placement.py``) and a dead NPU's router is considered dead too,
    so its mesh links carry no traffic.
  * ``dead_links`` — undirected ``(a, b)`` NPU-id pairs.  Only meaningful on
    the 2D mesh, and only for pairs that are actual mesh edges under the
    fabric's (rows, cols) shape; non-edges are ignored (a mask sampled for
    one shape stays usable across a shape sweep).
  * ``dead_uplinks`` — ``(l1_index, n_dead)`` pairs: severed L1→L2 uplinks
    on a FRED fabric.  An NPU's single link to its L1 switch is identified
    with the NPU itself (a dead NPU-link *is* a dead NPU).

Masks are frozen and fully hashable, so they slot directly into the
placement / collective-structure memo keys.  An *empty* mask (no defects)
is normalized away at the Simulator boundary so the zero-defect code path
is literally the pre-defect code path — bit-identical by construction.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, Optional, Sequence, Tuple

Link = Tuple[int, int]


def _norm_link(a: int, b: int) -> Link:
    return (a, b) if a <= b else (b, a)


@dataclasses.dataclass(frozen=True)
class DefectMask:
    """One defect draw over a wafer of ``n_npus`` NPUs."""

    n_npus: int
    dead_npus: Tuple[int, ...] = ()
    dead_links: Tuple[Link, ...] = ()
    dead_uplinks: Tuple[Tuple[int, int], ...] = ()
    seed: int = -1                      # sampler seed; -1 for hand-built masks

    def __post_init__(self):
        dead = tuple(sorted(set(self.dead_npus)))
        links = tuple(sorted({_norm_link(a, b) for a, b in self.dead_links}))
        ups = tuple(sorted(dict(self.dead_uplinks).items()))
        object.__setattr__(self, "dead_npus", dead)
        object.__setattr__(self, "dead_links", links)
        object.__setattr__(self, "dead_uplinks", ups)
        if dead and not (0 <= dead[0] and dead[-1] < self.n_npus):
            raise ValueError(f"dead NPU id out of range 0..{self.n_npus - 1}")
        if len(dead) >= self.n_npus:
            raise ValueError("mask kills every NPU on the wafer")

    # ---- queries ----------------------------------------------------------
    @property
    def is_empty(self) -> bool:
        return not (self.dead_npus or self.dead_links or self.dead_uplinks)

    @property
    def n_healthy(self) -> int:
        return self.n_npus - len(self.dead_npus)

    @property
    def dead_npu_rate(self) -> float:
        return len(self.dead_npus) / self.n_npus

    def healthy(self) -> Tuple[int, ...]:
        """Sorted healthy NPU ids — the compaction target of placement."""
        dead = set(self.dead_npus)
        return tuple(i for i in range(self.n_npus) if i not in dead)

    def npu_dead(self, nid: int) -> bool:
        return nid in set(self.dead_npus)

    def link_dead(self, a: int, b: int) -> bool:
        """True if the (a, b) link is dead — explicitly, or because either
        endpoint's router died with its NPU."""
        dead = set(self.dead_npus)
        return (a in dead or b in dead
                or _norm_link(a, b) in set(self.dead_links))

    def dead_uplinks_of(self, l1: int) -> int:
        return dict(self.dead_uplinks).get(l1, 0)

    # ---- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "n_npus": self.n_npus,
            "dead_npus": list(self.dead_npus),
            "dead_links": [list(l) for l in self.dead_links],
            "dead_uplinks": [list(u) for u in self.dead_uplinks],
            "seed": self.seed,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "DefectMask":
        d = json.loads(text)
        return cls(n_npus=d["n_npus"],
                   dead_npus=tuple(d.get("dead_npus", ())),
                   dead_links=tuple((a, b) for a, b in d.get("dead_links", ())),
                   dead_uplinks=tuple((l1, n) for l1, n
                                      in d.get("dead_uplinks", ())),
                   seed=d.get("seed", -1))


def mesh_links(rows: int, cols: int) -> Tuple[Link, ...]:
    """All undirected links of a rows×cols 2D mesh (id = r*cols + c)."""
    out = []
    for r in range(rows):
        for c in range(cols):
            nid = r * cols + c
            if c + 1 < cols:
                out.append((nid, nid + 1))
            if r + 1 < rows:
                out.append((nid, nid + cols))
    return tuple(out)


def _demote_unreachable(n_npus: int, dead_npus: Sequence[int],
                        dead_links: Sequence[Link],
                        mesh_shape: Tuple[int, int]) -> Sequence[int]:
    """Healthy NPUs cut off from the largest healthy region of the mesh
    are useless — no traffic can reach them — so the sampler counts them
    as dead.  Keeps the largest connected component (ties broken by the
    lowest member id), guaranteeing defect routing never fails between
    two healthy NPUs of a sampled mask."""
    dead = set(dead_npus)
    deadl = {_norm_link(a, b) for a, b in dead_links}
    adj: Dict[int, list] = {i: [] for i in range(n_npus) if i not in dead}
    for a, b in mesh_links(*mesh_shape):
        if a in dead or b in dead or (a, b) in deadl:
            continue
        adj[a].append(b)
        adj[b].append(a)
    seen: set = set()
    comps = []
    for start in sorted(adj):
        if start in seen:
            continue
        comp = [start]
        seen.add(start)
        q = [start]
        while q:
            nid = q.pop()
            for nb in adj[nid]:
                if nb not in seen:
                    seen.add(nb)
                    comp.append(nb)
                    q.append(nb)
        comps.append(comp)
    if len(comps) <= 1:
        return sorted(dead)
    comps.sort(key=lambda c: (-len(c), min(c)))
    keep = set(comps[0])
    return sorted(dead | {i for i in adj if i not in keep})


def sample_mask(n_npus: int, *, dead_npu_rate: float = 0.0,
                dead_link_rate: float = 0.0, dead_uplink_rate: float = 0.0,
                seed: int = 0, mesh_shape: Optional[Tuple[int, int]] = None,
                n_groups: int = 0, uplinks_per_l1: int = 0) -> DefectMask:
    """Draw a mask: each element fails independently at its rate.

    Deterministic in ``seed`` (``random.Random``, no global state).  Link
    kills need ``mesh_shape`` to enumerate the edge set; uplink kills need
    ``n_groups`` × ``uplinks_per_l1``.  At least one NPU always survives,
    and with ``mesh_shape`` the surviving NPUs form one connected mesh
    region (NPUs stranded by the draw are demoted to dead — an
    unreachable NPU can do no work).
    """
    rng = random.Random(seed)
    dead_npus = [i for i in range(n_npus) if rng.random() < dead_npu_rate]
    if len(dead_npus) >= n_npus:
        dead_npus = dead_npus[:-1]
    dead_links: Sequence[Link] = ()
    if mesh_shape is not None and dead_link_rate > 0.0:
        dead_links = [l for l in mesh_links(*mesh_shape)
                      if rng.random() < dead_link_rate]
    if mesh_shape is not None and (dead_npus or dead_links) \
            and mesh_shape[0] * mesh_shape[1] == n_npus:
        dead_npus = list(_demote_unreachable(n_npus, dead_npus, dead_links,
                                             mesh_shape))
        if len(dead_npus) >= n_npus:
            raise ValueError(
                f"defect draw (seed={seed}) disconnects every NPU")
    dead_uplinks: Dict[int, int] = {}
    if n_groups and uplinks_per_l1 and dead_uplink_rate > 0.0:
        for l1 in range(n_groups):
            n_dead = sum(1 for _ in range(uplinks_per_l1)
                         if rng.random() < dead_uplink_rate)
            # keep at least one uplink alive — a fully severed L1 is a
            # dead group, which the cost model treats as unplaceable anyway
            n_dead = min(n_dead, uplinks_per_l1 - 1)
            if n_dead:
                dead_uplinks[l1] = n_dead
    return DefectMask(n_npus=n_npus, dead_npus=tuple(dead_npus),
                      dead_links=tuple(dead_links),
                      dead_uplinks=tuple(dead_uplinks.items()), seed=seed)


def mesh_connected(mask: DefectMask, rows: int, cols: int) -> bool:
    """True iff the mask's healthy NPUs form one connected region on a
    rows×cols mesh.  A mask is sampled in flat id space, so the same
    draw can leave one mesh shape connected and cut another in two —
    shape sweeps skip the disconnected shapes (no collective can run
    across a severed wafer)."""
    demoted = _demote_unreachable(rows * cols, mask.dead_npus,
                                  mask.dead_links, (rows, cols))
    return len(demoted) == len(mask.dead_npus)


def normalize(mask: Optional[DefectMask]) -> Optional[DefectMask]:
    """Empty masks → None, so all-healthy draws share the no-mask path."""
    return None if mask is None or mask.is_empty else mask


# ---- per-wafer mask lists (WaferCluster.wafer_defects) --------------------

def masks_to_json(masks: Sequence[Optional[DefectMask]]) -> str:
    """JSON for a per-wafer mask list — one entry per wafer, ``null`` for
    a pristine wafer (the on-disk form of
    ``ClusterSpec.wafer_defects``)."""
    return json.dumps([None if m is None else json.loads(m.to_json())
                       for m in masks], sort_keys=True)


def masks_from_json(text: str) -> Tuple[Optional[DefectMask], ...]:
    """Inverse of :func:`masks_to_json`; entries are normalized (an empty
    mask loads as None)."""
    return tuple(None if e is None
                 else normalize(DefectMask.from_json(json.dumps(e)))
                 for e in json.loads(text))
