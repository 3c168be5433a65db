"""Consolidated fabric / cluster construction specs for the Simulator.

The PyTorch port's own copy of ``repro.core.specs``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

``Simulator`` historically grew one kwarg per axis (mesh_shape, fred_shape,
n_io, n_wafers, inter_wafer_*, inter_topology, hierarchy — ten in total).
These two frozen dataclasses are the consolidated front door:

    Simulator("FRED-D", spec=FabricSpec(fred_shape=(8, 8)),
              cluster_spec=ClusterSpec(n_wafers=4, inter_topology="switch"))

``FabricSpec`` describes one wafer (shape, I/O, and its defect draw);
``ClusterSpec`` describes how wafers stack into racks/pods.  The legacy
kwargs survive as thin deprecation shims that build a spec (see
``Simulator.__post_init__``) and produce bit-identical Breakdowns.

The same consolidation fronts the *decision* layer:
``autostrategy.choose_strategy`` had grown the identical kwarg sprawl
(``objective=``, ``mtbf_npu_hours=``, ``ep_candidates=``, ...), and
serving added a third objective family.  :class:`Objective` names *what
to optimize* (time | goodput | serving, with the family's parameters)
and :class:`DeploymentRequest` names *what to deploy* (model, hardware
axes, strategy axes) — ``autostrategy.choose(request)`` is the one entry
point for training and serving alike, and the legacy
``choose_strategy(**kwargs)`` call form is a ``DeprecationWarning`` shim
that builds the equivalent request (bit-identical decisions).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, TYPE_CHECKING

from .defects import DefectMask, normalize
from .workloads import DEFAULT_NPU_HBM_BYTES

if TYPE_CHECKING:
    from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """One wafer: fabric shape, I/O controllers, and the defect draw.

    ``mesh_shape`` applies to the baseline 2D mesh, ``fred_shape``
    (n_groups, group_size) to the FRED fabrics; leave either None for the
    fabric's paper default.  ``defects`` is interpreted by whichever fabric
    is built (see core/defects.py for the id-space overlay rules).
    """
    mesh_shape: Optional[Tuple[int, int]] = None
    fred_shape: Optional[Tuple[int, int]] = None
    n_io: Optional[int] = None
    defects: Optional[DefectMask] = None

    def __post_init__(self):
        object.__setattr__(self, "defects", normalize(self.defects))


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Inter-wafer scale-out: wafer count / stacking and the link model.

    ``wafer_defects`` carries one :class:`DefectMask` (or None for a
    pristine wafer) per wafer — the cluster-honest alternative to
    ``FabricSpec.defects``, which applies a single mask to *every* wafer.
    The two are mutually exclusive (enforced by the Simulator); an
    all-None tuple normalizes away so the pristine path stays
    bit-identical.
    """
    n_wafers: int = 1
    hierarchy: Optional[Tuple[int, ...]] = None
    inter_topology: str = "ring"
    inter_wafer_links: int = 32
    inter_wafer_bw: float = 400e9
    inter_wafer_latency: float = 5e-7   # repro: unit[s] (per inter-level step)
    wafer_defects: Optional[Tuple[Optional[DefectMask], ...]] = None

    def __post_init__(self):
        if self.hierarchy is not None:
            object.__setattr__(self, "hierarchy", tuple(self.hierarchy))
        if self.wafer_defects is not None:
            masks = tuple(normalize(m) for m in self.wafer_defects)
            object.__setattr__(
                self, "wafer_defects",
                None if all(m is None for m in masks) else masks)


DEFAULT_FABRIC_SPEC = FabricSpec()
DEFAULT_CLUSTER_SPEC = ClusterSpec()


@dataclasses.dataclass(frozen=True)
class Objective:
    """What a deployment optimizes — the typed successor to
    ``choose_strategy``'s objective kwargs.

    ``kind`` selects the family and which parameter block applies:

    * ``"time"`` — healthy per-iteration time (no parameters).
    * ``"goodput"`` — MTBF-driven lifetime goodput: the mtbf /
      mission / restart block.
    * ``"serving"`` — SLO-constrained serving throughput: the
      SLO / traffic / request-profile block.  Offered load is
      ``arrival_rate_rps`` if positive, else
      ``concurrent_users / think_time_s``.

    Prefer the :meth:`time` / :meth:`goodput` / :meth:`serving`
    constructors — they keep the irrelevant blocks at their inert
    defaults, which is what the bit-identity shims rely on.
    """
    kind: str = "time"
    # -- goodput block ----------------------------------------------------
    mtbf_npu_hours: float = math.inf
    mtbf_wafer_hours: float = math.inf
    mission_hours: float = 720.0
    restart_s: float = 60.0
    goodput_top_k: int = 32
    n_failure_states: int = 3
    failure_seed: int = 0
    # -- serving block ----------------------------------------------------
    target_p99_ms: float = 200.0
    arrival_rate_rps: float = 0.0
    concurrent_users: int = 0
    think_time_s: float = 60.0
    prompt_tokens: int = 1024
    output_tokens: int = 256

    def __post_init__(self):
        if self.kind not in ("time", "goodput", "serving"):
            raise ValueError(
                f"Objective.kind must be time|goodput|serving, "
                f"got {self.kind!r}")

    @classmethod
    def time(cls) -> "Objective":
        return cls(kind="time")

    @classmethod
    def goodput(cls, *, mtbf_npu_hours: float = math.inf,
                mtbf_wafer_hours: float = math.inf,
                mission_hours: float = 720.0, restart_s: float = 60.0,
                goodput_top_k: int = 32, n_failure_states: int = 3,
                failure_seed: int = 0) -> "Objective":
        return cls(kind="goodput", mtbf_npu_hours=mtbf_npu_hours,
                   mtbf_wafer_hours=mtbf_wafer_hours,
                   mission_hours=mission_hours, restart_s=restart_s,
                   goodput_top_k=goodput_top_k,
                   n_failure_states=n_failure_states,
                   failure_seed=failure_seed)

    @classmethod
    def serving(cls, *, target_p99_ms: float = 200.0,
                arrival_rate_rps: float = 0.0, concurrent_users: int = 0,
                think_time_s: float = 60.0, prompt_tokens: int = 1024,
                output_tokens: int = 256) -> "Objective":
        return cls(kind="serving", target_p99_ms=target_p99_ms,
                   arrival_rate_rps=arrival_rate_rps,
                   concurrent_users=concurrent_users,
                   think_time_s=think_time_s, prompt_tokens=prompt_tokens,
                   output_tokens=output_tokens)


@dataclasses.dataclass(frozen=True)
class DeploymentRequest:
    """What to deploy and over which axes to search — the one argument of
    ``autostrategy.choose``.

    ``model`` is a registry :class:`~repro_torch.models.config.ModelConfig`;
    ``shape`` a :class:`~repro_torch.models.config.ShapeConfig` (required for
    training objectives, ignored by serving, whose request profile lives
    on the :class:`Objective`).  The remaining fields mirror the legacy
    ``choose_strategy`` kwargs one-for-one, same defaults — a shim-built
    request decides bit-identically.
    """
    model: "ModelConfig"
    shape: Optional["ShapeConfig"] = None
    objective: Objective = Objective()
    n_npus: int = 64
    fabrics: Tuple[str, ...] = ("baseline", "FRED-C", "FRED-D")
    max_wafers: int = 2
    inter_topologies: Tuple[str, ...] = ("ring", "fully_connected",
                                         "switch")
    max_levels: int = 1
    npu_hbm_bytes: float = DEFAULT_NPU_HBM_BYTES
    master: bool = True
    moments_dtype: str = "float32"
    remat: str = "full"
    min_utilization: float = 0.9
    prune_symmetric: bool = True
    ep_candidates: Tuple[int, ...] = (1,)
    sp_candidates: Tuple[int, ...] = (1,)
    comm_overlap_fraction: float = 0.0
