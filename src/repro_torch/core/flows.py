"""Communication *flows* and Table-I collective decompositions (Sec. V-A).

The PyTorch port's own copy of ``repro.core.flows``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

A flow on FRED_m(P) is (IPs, OPs): reduce the data arriving on the input
ports IPs and broadcast the result to the output ports OPs.  Simple
collectives are one flow; compound collectives decompose into serial flow
steps exactly as Table I prescribes.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Flow:
    """One reduction-distribution flow."""
    ips: FrozenSet[int]
    ops: FrozenSet[int]
    bytes: float = 0.0          # payload carried by this flow
    tag: str = ""               # which collective/group it belongs to

    @staticmethod
    def make(ips: Sequence[int], ops: Sequence[int], nbytes: float = 0.0,
             tag: str = "") -> "Flow":
        return Flow(frozenset(ips), frozenset(ops), nbytes, tag)

    def __repr__(self):
        return (f"Flow({sorted(self.ips)}→{sorted(self.ops)}"
                f"{', ' + self.tag if self.tag else ''})")


# --------------------------------------------------------------------------
# Table I — simple collectives: exactly one flow
# --------------------------------------------------------------------------

def unicast(src: int, dst: int, nbytes: float = 0.0, tag="unicast") -> List[List[Flow]]:
    return [[Flow.make([src], [dst], nbytes, tag)]]


def multicast(src: int, dsts: Sequence[int], nbytes: float = 0.0,
              tag="multicast") -> List[List[Flow]]:
    return [[Flow.make([src], dsts, nbytes, tag)]]


def reduce(srcs: Sequence[int], dst: int, nbytes: float = 0.0,
           tag="reduce") -> List[List[Flow]]:
    return [[Flow.make(srcs, [dst], nbytes, tag)]]


def all_reduce(peers: Sequence[int], nbytes: float = 0.0,
               tag="all_reduce") -> List[List[Flow]]:
    """Input ports and output ports are the same — one flow."""
    return [[Flow.make(peers, peers, nbytes, tag)]]


# --------------------------------------------------------------------------
# Table I — compound collectives: serial steps of flows
# --------------------------------------------------------------------------

def reduce_scatter(peers: Sequence[int], nbytes: float = 0.0,
                   tag="reduce_scatter") -> List[List[Flow]]:
    """i serial Reduce steps, step j reducing shard j onto peer j."""
    n = len(peers)
    shard = nbytes / max(n, 1)
    return [[Flow.make(peers, [p], shard, f"{tag}[{j}]")]
            for j, p in enumerate(peers)]


def all_gather(peers: Sequence[int], nbytes: float = 0.0,
               tag="all_gather") -> List[List[Flow]]:
    """i serial Multicast steps, step j broadcasting peer j's shard."""
    n = len(peers)
    shard = nbytes / max(n, 1)
    return [[Flow.make([p], peers, shard, f"{tag}[{j}]")]
            for j, p in enumerate(peers)]


def scatter(src: int, dsts: Sequence[int], nbytes: float = 0.0,
            tag="scatter") -> List[List[Flow]]:
    shard = nbytes / max(len(dsts), 1)
    return [[Flow.make([src], [d], shard, f"{tag}[{j}]")]
            for j, d in enumerate(dsts)]


def gather(srcs: Sequence[int], dst: int, nbytes: float = 0.0,
           tag="gather") -> List[List[Flow]]:
    shard = nbytes / max(len(srcs), 1)
    return [[Flow.make([s], [dst], shard, f"{tag}[{j}]")]
            for j, s in enumerate(srcs)]


def all_to_all(peers: Sequence[int], nbytes: float = 0.0,
               tag="all_to_all") -> List[List[Flow]]:
    """i serial steps; in step j every input unicasts to the output at
    distance j (Table I) — each step is a parallel set of disjoint
    unicasts, which FRED routes concurrently."""
    n = len(peers)
    shard = nbytes / max(n, 1)
    steps = []
    for j in range(n):
        step = [Flow.make([peers[i]], [peers[(i + j) % n]], shard,
                          f"{tag}[{j}]") for i in range(n)]
        steps.append(step)
    return steps


COLLECTIVES = {
    "unicast": unicast, "multicast": multicast, "reduce": reduce,
    "all_reduce": all_reduce, "reduce_scatter": reduce_scatter,
    "all_gather": all_gather, "scatter": scatter, "gather": gather,
    "all_to_all": all_to_all,
}


def endpoint_traffic_bytes(kind: str, n: int, nbytes: float) -> float:
    """Per-NPU send traffic for the *endpoint* (ring) algorithm — the
    baseline FRED compares against (Sec. II-B): All-Reduce costs each NPU
    2(N−1)/N·D; RS/AG cost (N−1)/N·D; A2A (N−1)/N·D."""
    if n <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * (n - 1) / n * nbytes
    if kind in ("reduce_scatter", "all_gather", "all_to_all"):
        return (n - 1) / n * nbytes
    if kind in ("reduce", "multicast", "unicast"):
        return nbytes
    raise ValueError(f"unknown collective kind {kind!r}; "
                     f"expected one of {sorted(COLLECTIVES)}")


def innetwork_traffic_bytes(kind: str, n: int, nbytes: float) -> float:
    """Per-NPU send traffic with in-switch execution: All-Reduce of D costs
    each NPU exactly D (send once, receive once) — the ≈2× reduction."""
    if n <= 1:
        return 0.0
    if kind == "all_reduce":
        return nbytes
    if kind in ("reduce_scatter", "all_gather", "all_to_all"):
        return (n - 1) / n * nbytes
    if kind in ("reduce", "multicast", "unicast"):
        return nbytes
    raise ValueError(f"unknown collective kind {kind!r}; "
                     f"expected one of {sorted(COLLECTIVES)}")
