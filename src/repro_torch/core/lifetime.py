"""Lifetime goodput: MTBF-driven failures, checkpoints, elastic decay.

The PyTorch port's own copy of ``repro.core.lifetime``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_decide.py`` holds
its results equal to the original's.  One addition: ``device`` (``cuda`` unless
given) is where the fallback re-sweeps run their float math.

A strategy tuned for the pristine wafer is only the right choice if it
still wins over the *lifetime* of a training run: hardware fails at some
MTBF, every failure costs a recovery plus the work since the last
checkpoint, and each checkpoint itself steals wall-clock.  This module
converts the simulator's per-iteration times into **lifetime goodput** —
useful samples per wall-clock second over a whole mission — so
auto-strategy can rank a slightly-slower-but-survivable strategy above a
fragile healthy-time winner (``choose_strategy(objective="goodput")``).

Three layers:

  1. **Checkpoint math** (Young–Daly style, closed form).  With
     exponential failures at system MTBF ``M``, checkpoint write cost
     ``δ`` and restart cost ``R``, the expected wall time to commit one
     segment of ``τ`` useful work is ``(M + R)·(e^{(τ+δ)/M} − 1)``
     (memoryless restart-from-checkpoint renewal).  ``optimal_interval``
     maximizes the useful fraction (seeded by Young–Daly
     ``τ* ≈ √(2δM)``), and ``time_fractions`` decomposes wall-clock into
     useful / checkpoint / lost-work / recovery exactly.

  2. **Degradation chain** (yield_study-style).  Failures don't return
     the run to a pristine wafer: each one kills hardware and the run
     re-plans onto the survivors.  ``degradation_chain`` draws a seeded
     kill order, asks :func:`~repro_torch.core.yield_study._winner_survives`
     whether the candidate still runs (degraded) after ``k`` failures,
     and re-sweeps under the cumulative mask when it doesn't — the same
     fallback decision the auto-strategy would make on that wafer.  A
     chain that hits "no feasible fallback" is dead: the remaining
     mission produces zero goodput, which is exactly what makes fragile
     winners lose.

  3. **Mission estimate / event simulation**.  ``estimate_lifetime``
     walks the expected failure states deterministically (state ``k``
     lasts one system-MTBF on average) and averages goodput over the
     mission; ``simulate_lifetime`` is the seeded event-driven
     cross-check the tests compare against the closed form.

The checkpoint write cost is derived from the :class:`MemoryModel`'s
persistent state bytes (weights + optimizer — activations are
recomputed, not checkpointed) pushed through the fabric's wafer I/O
rate, so a bigger optimizer or a slimmer fabric genuinely changes the
optimal interval.

At ``mtbf = ∞`` (or zero checkpoint cost) the useful fraction is exactly
1.0 and goodput reduces to ``1 / time_per_sample`` — ranking by goodput
is then *bit-identical* to ranking by time, which is how the pre-lifetime
goldens stay byte-identical (pinned by ``tests/test_lifetime.py``).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .defects import DefectMask, normalize
from .sweep import SweepResult, _simulator, sweep
from .workloads import MemoryModel, Workload, BYTES, optimizer_bytes_per_param
from .yield_study import _winner_survives

HOUR_S = 3600.0                 # repro: unit[s]

# Mission / recovery defaults shared by choose_strategy(objective=
# "goodput"), benchmarks.run --only lifetimesweep, and the golden
# generator — one month of training, a one-minute restart (process
# respawn + re-shard + data-pipeline rewind).
DEFAULT_MISSION_HOURS = 720.0
DEFAULT_RESTART_S = 60.0        # repro: unit[s]


# --------------------------------------------------------------------------
# failure model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Exponential failure rates plus the mission the run must survive.

    ``mtbf_npu_hours`` is the per-NPU mean time between failures;
    ``mtbf_wafer_hours`` covers whole-wafer events (power, cooling,
    host).  The system rate adds one exponential clock per *used* NPU
    and per used wafer — idle spares don't take the run down when they
    die (they become unavailable for later re-planning, which the
    degradation chain's cumulative kill order models)."""
    mtbf_npu_hours: float = math.inf
    mtbf_wafer_hours: float = math.inf
    restart_s: float = DEFAULT_RESTART_S     # repro: unit[s]
    mission_hours: float = DEFAULT_MISSION_HOURS

    @property
    def mission_s(self) -> float:            # repro: unit[s]
        return self.mission_hours * HOUR_S

    def system_mtbf_s(self, n_npus: int, n_wafers: int = 1) -> float:
        """MTBF of the whole system, seconds.  ``inf`` when nothing
        fails."""
        rate = 0.0
        if not math.isinf(self.mtbf_npu_hours):
            rate += n_npus / (self.mtbf_npu_hours * HOUR_S)
        if not math.isinf(self.mtbf_wafer_hours):
            rate += n_wafers / (self.mtbf_wafer_hours * HOUR_S)
        return math.inf if rate == 0.0 else 1.0 / rate


# --------------------------------------------------------------------------
# checkpoint cost from the memory model
# --------------------------------------------------------------------------

def checkpoint_state_bytes(w: Workload, mem: MemoryModel) -> float:
    """Total persistent state one checkpoint must capture, bytes.

    Weights plus optimizer state for the whole model (summed over all
    shards — the write crosses the wafer I/O either way); activations
    are recomputed on restore, never written.  Weight-streaming runs
    keep the optimizer near storage but the checkpoint still has to
    commit it — same byte count, same I/O path."""
    params = w.params_per_layer * w.n_layers
    per_param = float(BYTES)
    if mem.training:
        per_param += optimizer_bytes_per_param(mem.master, mem.moments_dtype)
    return params * per_param


def checkpoint_write_s(w: Workload, mem: MemoryModel,
                       wafer_io_rate: float) -> float:
    """Seconds per checkpoint: state bytes over the aggregate I/O rate
    of the wafers the strategy actually spans (wafers write their shards
    in parallel)."""
    bw = wafer_io_rate * max(w.strategy.wafers, 1)
    return checkpoint_state_bytes(w, mem) / bw


# --------------------------------------------------------------------------
# Young–Daly checkpoint-interval math (closed form)
# --------------------------------------------------------------------------

def young_daly_interval(ckpt_s: float, mtbf_s: float) -> float:
    """The classic first-order optimum ``τ* = √(2δM)``, seconds."""
    if math.isinf(mtbf_s) or ckpt_s <= 0.0:
        return math.inf if math.isinf(mtbf_s) else 0.0
    return math.sqrt(2.0 * ckpt_s * mtbf_s)


def useful_fraction(interval_s: float, ckpt_s: float, restart_s: float,
                    mtbf_s: float) -> float:
    """Expected fraction of wall-clock doing useful work at a fixed
    checkpoint interval — exact under exponential failures.

    A segment is ``τ`` useful work + the ``δ`` checkpoint write; a
    failure at any point restarts the segment after ``R`` recovery.  The
    renewal expectation for one committed segment is
    ``E = (M + R)·(e^{(τ+δ)/M} − 1)``, so the fraction is ``τ / E``.
    ``mtbf = ∞`` degenerates to ``τ/(τ+δ)`` and zero checkpoint cost to
    exactly 1.0."""
    if interval_s <= 0.0:
        raise ValueError(f"checkpoint interval must be > 0, got "
                         f"{interval_s}")
    if math.isinf(mtbf_s):
        if ckpt_s == 0.0:
            return 1.0
        return interval_s / (interval_s + ckpt_s)
    length = interval_s + ckpt_s
    return interval_s / ((mtbf_s + restart_s) * math.expm1(length / mtbf_s))


def optimal_interval(ckpt_s: float, restart_s: float, mtbf_s: float, *,
                     min_interval_s: float = 1.0) -> float:
    """The interval maximizing :func:`useful_fraction` (exact model, not
    just the Young–Daly seed), via deterministic ternary search — the
    objective is unimodal in ``τ``.  ``inf`` when nothing ever fails
    (never checkpoint)."""
    if math.isinf(mtbf_s):
        return math.inf
    if ckpt_s <= 0.0:
        return min_interval_s
    seed = young_daly_interval(ckpt_s, mtbf_s)
    lo = min_interval_s
    hi = max(8.0 * seed, 2.0 * lo)
    for _ in range(200):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        if useful_fraction(m1, ckpt_s, restart_s, mtbf_s) \
                < useful_fraction(m2, ckpt_s, restart_s, mtbf_s):
            lo = m1
        else:
            hi = m2
    return (lo + hi) / 2.0


def time_fractions(interval_s: float, ckpt_s: float, restart_s: float,
                   mtbf_s: float) -> Dict[str, float]:
    """Exact wall-clock decomposition at a fixed interval: fractions of
    expected time spent on useful steps, checkpoint writes, recovery
    (restarts), and lost work (progress a failure threw away).  Sums to
    1.0."""
    if math.isinf(mtbf_s):
        length = interval_s + ckpt_s
        if ckpt_s == 0.0:
            return {"useful": 1.0, "checkpoint": 0.0, "lost": 0.0,
                    "recovery": 0.0}
        return {"useful": interval_s / length, "checkpoint": ckpt_s / length,
                "lost": 0.0, "recovery": 0.0}
    length = interval_s + ckpt_s
    fails = math.expm1(length / mtbf_s)     # expected failures per segment
    expected = (mtbf_s + restart_s) * fails
    useful = interval_s / expected
    ckpt = ckpt_s / expected
    recovery = restart_s * fails / expected
    lost = max(0.0, 1.0 - useful - ckpt - recovery)
    return {"useful": useful, "checkpoint": ckpt, "lost": lost,
            "recovery": recovery}


# --------------------------------------------------------------------------
# elastic degradation chain (yield_study-style fallback re-sweeps)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LifetimePoint:
    """One degradation state: the run after ``n_failed`` NPU deaths."""
    n_failed: int
    alive: bool
    time_per_sample_s: float          # repro: unit[s] (0.0 when dead)
    source: str                       # winner | degraded | fallback | dead
    reason: str = ""                  # why the previous plan died
    fallback: Optional[SweepResult] = None


def _rank_key(r: SweepResult):
    """autostrategy's deterministic tiebreak chain (duplicated here to
    keep core/lifetime.py importable without core/autostrategy.py)."""
    from .cluster import TOPOLOGY_CODES
    return (r.time_per_sample, r.memory_bytes_per_npu, r.n_wafers,
            TOPOLOGY_CODES.get(r.inter_topology, -1), len(r.hierarchy),
            r.fabric, r.hierarchy, r.shape,
            (r.strategy.mp, r.strategy.dp, r.strategy.pp,
             r.strategy.ep, r.strategy.sp))


def _same_hardware(a: SweepResult, b: SweepResult) -> bool:
    """True when ``a`` runs on the hardware ``b`` was deployed on — a
    mid-run re-plan can change the parallelization, never the wafer."""
    return (a.fabric, a.shape, a.n_wafers, a.inter_topology, a.hierarchy) \
        == (b.fabric, b.shape, b.n_wafers, b.inter_topology, b.hierarchy)


def _elastic_reachable(a: SweepResult, b: SweepResult) -> bool:
    """True when a mid-run recovery can re-plan deployment ``b`` into
    ``a`` — the cost-model mirror of ``train/elastic.py``'s
    ``plan_shrink``: the DP degree flexes freely, the model axis keeps
    its tensor layout (``mp`` stays or shrinks to a divisor, exactly the
    head/FFN-divisibility story), and the pipeline/expert/sequence axes
    are frozen (re-balancing stages or re-sharding experts mid-run is a
    cold restart, not a recovery)."""
    sa, sb = a.strategy, b.strategy
    return (sa.pp == sb.pp and sa.ep == sb.ep and sa.sp == sb.sp
            and sa.wafers == sb.wafers
            and sa.mp <= sb.mp and sb.mp % sa.mp == 0)


def degradation_chain(workload_fn: Callable, winner: SweepResult,
                      n_npus: int, *,
                      n_states: int = 3,
                      seed: int = 0,
                      compute_efficiency: float = 0.45,
                      sweep_kw: Optional[Dict] = None,
                      inter_kw: Optional[Dict] = None,
                      check_routing: bool = False,
                      uplinks: Optional[int] = None,
                      fallback_cache: Optional[Dict] = None,
                      device=None) -> List[LifetimePoint]:
    """States 0..``n_states``: step time after each cumulative failure.

    A seeded kill order (``random.Random(seed)``) fixes which NPU dies
    at each failure; state ``k`` evaluates the candidate under the
    cumulative ``k``-dead mask exactly the way the yield study does —
    degraded in place when it survives, re-swept onto the survivors when
    it doesn't.  Unlike the yield study's free fallback, the re-sweep is
    pinned to the *deployed hardware* (same fabric, wafer shape, wafer
    count, inter topology — a mid-run failure can re-plan the
    parallelization, not re-wire the wafer) and to the
    *elastic-reachable* strategies (:func:`_elastic_reachable`: DP
    flexes, MP keeps or shrinks to a divisor, PP/EP/SP frozen — the cost
    model mirror of ``train/elastic.py``'s ``plan_shrink``).  That
    restriction is what makes fragility real: an MP(1)-DP(n) deployment
    has nowhere to re-plan to when DP candidates dry up, while an
    MP-heavy sibling can fold its model axis down.  ``fallback_cache``
    shares the per-(mask, hardware, reachability) re-sweeps across
    candidates.  The chain ends early at the first state with no
    feasible fallback; everything after is dead time.  ``device``
    (``cuda`` unless given) runs the re-sweeps."""
    sweep_kw = dict(sweep_kw or {})
    inter_kw = dict(inter_kw or {})
    rng = random.Random(seed)
    order = rng.sample(range(n_npus), min(n_states, n_npus - 1))
    points = [LifetimePoint(n_failed=0, alive=True,
                            time_per_sample_s=winner.time_per_sample,
                            source="winner")]
    cache = fallback_cache if fallback_cache is not None else {}
    for k in range(1, len(order) + 1):
        mask = normalize(DefectMask(n_npus, dead_npus=tuple(order[:k])))
        assert mask is not None
        ok, reason, t = _winner_survives(
            winner, workload_fn, mask, n_npus, compute_efficiency,
            check_routing, uplinks, inter_kw)
        if ok:
            scale = t / winner.total if winner.total > 0 else 1.0
            points.append(LifetimePoint(
                n_failed=k, alive=True,
                time_per_sample_s=winner.time_per_sample * scale,
                source="degraded"))
            continue
        st = winner.strategy
        ck = (mask, winner.fabric, winner.shape, winner.n_wafers,
              winner.inter_topology, winner.hierarchy,
              st.mp, st.pp, st.ep, st.sp, st.wafers)
        if ck not in cache:
            try:
                kw = dict(sweep_kw)
                kw["fabrics"] = (winner.fabric,)
                cands = [x for x in sweep(workload_fn, n_npus,
                                          defects=mask, device=device,
                                          **kw)
                         if x.feasible and _same_hardware(x, winner)
                         and _elastic_reachable(x, winner)]
                cache[ck] = min(cands, key=_rank_key) if cands else None
            except ValueError:
                cache[ck] = None
        fb = cache[ck]
        if fb is None:
            points.append(LifetimePoint(n_failed=k, alive=False,
                                        time_per_sample_s=0.0,
                                        source="dead", reason=reason))
            break
        points.append(LifetimePoint(n_failed=k, alive=True,
                                    time_per_sample_s=fb.time_per_sample,
                                    source="fallback", reason=reason,
                                    fallback=fb))
    return points


# --------------------------------------------------------------------------
# mission-level estimate + event simulation
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LifetimeEstimate:
    """Mission-averaged verdict for one candidate strategy."""
    mtbf_s: float                     # repro: unit[s] (system MTBF)
    ckpt_write_s: float               # repro: unit[s]
    interval_s: float                 # repro: unit[s] (chosen, optimal)
    restart_s: float                  # repro: unit[s]
    mission_s: float                  # repro: unit[s]
    fractions: Dict[str, float]       # useful/checkpoint/lost/recovery
                                      # at the healthy state
    goodput_samples_per_s: float      # mission-averaged useful samples/s
    chain: Tuple[LifetimePoint, ...]  # degradation states traversed
    n_expected_failures: int

    @property
    def survives_mission(self) -> bool:
        return all(p.alive for p in self.chain)

    @property
    def samples_total(self) -> float:
        return self.goodput_samples_per_s * self.mission_s


def estimate_lifetime(chain: Sequence[LifetimePoint], *,
                      ckpt_write_s: float, restart_s: float, mtbf_s: float,
                      mission_s: float,
                      min_interval_s: float = 1.0) -> LifetimeEstimate:
    """Deterministic expectation walk over the degradation chain.

    The mission is partitioned into failure states: state ``k`` lasts
    one system-MTBF in expectation (the last one only to the mission
    end).  Each alive state contributes
    ``useful_fraction(τ*, δ, R, M) / time_per_sample`` samples per
    second; a chain exhausted while still alive holds its last step time
    (further failures keep landing on an already-degraded plan), and a
    dead chain contributes nothing for the rest of the mission."""
    interval = optimal_interval(ckpt_write_s, restart_s, mtbf_s,
                                min_interval_s=min_interval_s)
    if math.isinf(mtbf_s):
        # never fails → never checkpoints: the useful fraction is
        # exactly 1.0, making goodput ranking bit-identical to time
        fr = {"useful": 1.0, "checkpoint": 0.0, "lost": 0.0,
              "recovery": 0.0}
        t0 = chain[0].time_per_sample_s
        goodput = fr["useful"] / t0 if chain[0].alive and t0 > 0 else 0.0
        return LifetimeEstimate(
            mtbf_s=mtbf_s, ckpt_write_s=ckpt_write_s, interval_s=interval,
            restart_s=restart_s, mission_s=mission_s,
            fractions=fr, goodput_samples_per_s=goodput,
            chain=tuple(chain[:1]), n_expected_failures=0)
    fr = time_fractions(interval, ckpt_write_s, restart_s, mtbf_s)
    n_fail = int(mission_s // mtbf_s)
    samples = 0.0
    remaining = mission_s
    traversed: List[LifetimePoint] = []
    for k in range(n_fail + 1):
        duration = min(mtbf_s, remaining) if k < n_fail else remaining
        point = chain[min(k, len(chain) - 1)]
        traversed.append(point)
        if point.alive and point.time_per_sample_s > 0:
            samples += duration * fr["useful"] / point.time_per_sample_s
        remaining -= duration
        if not point.alive:
            break
    return LifetimeEstimate(
        mtbf_s=mtbf_s, ckpt_write_s=ckpt_write_s, interval_s=interval,
        restart_s=restart_s, mission_s=mission_s, fractions=fr,
        goodput_samples_per_s=samples / mission_s if mission_s > 0 else 0.0,
        chain=tuple(traversed), n_expected_failures=n_fail)


def simulate_lifetime(chain: Sequence[LifetimePoint], *,
                      ckpt_write_s: float, restart_s: float, mtbf_s: float,
                      mission_s: float, seed: int = 0,
                      interval_s: Optional[float] = None
                      ) -> Dict[str, float]:
    """Seeded event-driven cross-check of :func:`estimate_lifetime`.

    Draws exponential failure times (``random.Random(seed)``), runs the
    segment/checkpoint/restart loop, advances the degradation chain one
    state per failure, and tallies wall-clock per category.  Returns
    ``{"samples", "useful_s", "checkpoint_s", "lost_s", "recovery_s",
    "n_failures"}`` — the tests assert the long-run averages agree with
    the closed form."""
    rng = random.Random(seed)
    interval = interval_s if interval_s is not None else \
        optimal_interval(ckpt_write_s, restart_s, mtbf_s)
    tallies = {"samples": 0.0, "useful_s": 0.0, "checkpoint_s": 0.0,
               "lost_s": 0.0, "recovery_s": 0.0, "n_failures": 0.0}
    now = 0.0
    state = 0
    next_fail = rng.expovariate(1.0 / mtbf_s) if not math.isinf(mtbf_s) \
        else math.inf
    segment_done = 0.0            # useful seconds since last commit
    while now < mission_s:
        point = chain[min(state, len(chain) - 1)]
        if not point.alive:
            tallies["lost_s"] += mission_s - now
            break
        seg_len = interval if not math.isinf(interval) else mission_s - now
        end = now + (seg_len - segment_done) + ckpt_write_s
        if end <= next_fail or math.isinf(mtbf_s):
            work = seg_len - segment_done
            tallies["useful_s"] += work
            tallies["checkpoint_s"] += min(ckpt_write_s, mission_s - now)
            tallies["samples"] += work / point.time_per_sample_s
            now = end
            segment_done = 0.0
        else:
            lost = next_fail - now
            tallies["lost_s"] += lost
            tallies["recovery_s"] += restart_s
            tallies["n_failures"] += 1
            now = next_fail + restart_s
            segment_done = 0.0
            state += 1
            next_fail = now + rng.expovariate(1.0 / mtbf_s)
    return tallies


# --------------------------------------------------------------------------
# end-to-end candidate evaluation (what choose_strategy ranks by)
# --------------------------------------------------------------------------

def evaluate_candidate(workload_fn: Callable, r: SweepResult, n_npus: int, *,
                       failure: FailureModel, mem: MemoryModel,
                       n_states: int = 3, seed: int = 0,
                       compute_efficiency: float = 0.45,
                       sweep_kw: Optional[Dict] = None,
                       inter_kw: Optional[Dict] = None,
                       fallback_cache: Optional[Dict] = None,
                       device=None) -> LifetimeEstimate:
    """Lifetime estimate for one sweep candidate.

    Derives the checkpoint write cost from the candidate's own workload
    state bytes over its fabric's wafer I/O rate, the system MTBF from
    the NPUs/wafers the strategy actually uses, and the degradation
    chain from seeded cumulative failures with fallback re-sweeps.  At
    ``mtbf = ∞`` the chain is skipped entirely (nothing fails) and the
    estimate reduces to the healthy per-sample rate.  ``device`` is
    :func:`degradation_chain`'s."""
    st = r.strategy
    w = workload_fn(st)
    mtbf_s = failure.system_mtbf_s(st.mp * st.dp * st.pp,
                                   max(st.wafers, 1))
    inter_kw = dict(inter_kw or {})
    sim = _simulator(r.fabric, r.shape, n_npus, {}, compute_efficiency,
                     n_wafers=r.n_wafers,
                     hierarchy=r.hierarchy if r.n_wafers > 1 else None,
                     inter_topology=r.inter_topology, **inter_kw)
    ckpt_s = checkpoint_write_s(w, mem, sim._io_rate())
    if math.isinf(mtbf_s):
        chain: List[LifetimePoint] = [LifetimePoint(
            n_failed=0, alive=True, time_per_sample_s=r.time_per_sample,
            source="winner")]
    else:
        chain = degradation_chain(
            workload_fn, r, n_npus, n_states=n_states, seed=seed,
            compute_efficiency=compute_efficiency, sweep_kw=sweep_kw,
            inter_kw=inter_kw, fallback_cache=fallback_cache,
            device=device)
    return estimate_lifetime(chain, ckpt_write_s=ckpt_s,
                             restart_s=failure.restart_s, mtbf_s=mtbf_s,
                             mission_s=failure.mission_s)
