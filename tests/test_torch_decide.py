"""FRED's decision stack in the port (``repro_torch.core.{routing, serving,
yield_study, lifetime, autostrategy, calibrate}``) against the JAX package's
``repro.core``, on the CPU with ``device="cpu"``, with no tolerance: every
comparison is ``==``.  The only fields left out are wall-clock times, named
in ``WALL_CLOCK``: ``sweep_seconds`` (``AutoStrategyDecision``,
``ServingDecision``, the dry run's ``"autostrategy"`` block) and
``study_seconds`` (``YieldReport``).

(i)   routing: ``conflict_graph`` / ``color_graph`` / ``route`` / ``routable``
      on seeded disjoint and overlapping flow sets over ``FredSwitch.build(P,
      m)``, ``fig7j_flows``, ``strategy_routable`` over the canonical
      placements, the draw that fails ``test_random_disjoint_flows_route_on_m3``
      and the 20-NPU sweep with ``check_routing=True``;
(ii)  serving: ``model_terms``, ``phase_plans``, ``serving_candidates``, the
      queueing formulas and simulator, ``decide_serving`` and the servesweep
      table against ``tests/goldens/servesweep.json``;
(iii) autostrategy: ``choose`` for every architecture under the time and the
      serving objective (errors included), the autostrategy and epsweep
      goldens, the legacy shim;
(iv)  lifetime: the checkpoint math, one degradation chain with its estimate
      and simulation, the lifetimesweep golden;
(v)   yield: ``yield_study`` on seeded masks and the faultsweep golden;
(vi)  calibrate: the constants and ``simulate_speedups`` at three points;
(vii) the refusals with no device and no CUDA, ``cell_policy(autostrategy=
      True)`` against the JAX policy, and the dry run's ``"autostrategy"``
      block against the JAX tool's.
"""

import ast
import dataclasses
import json
import math
import pathlib
import random
import warnings

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core import (autostrategy as j_as, calibrate as j_cal, defects as j_df,
                        flows as j_fl, lifetime as j_lt, placement as j_pl,
                        routing as j_rt, serving as j_sv, specs as j_sp, sweep as j_sw,
                        switch as j_swi, workloads as j_wl, yield_study as j_ys)
from repro.models.config import SHAPES_BY_NAME as J_SHAPES
from repro.parallel import policy as j_policy

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import (autostrategy as t_as, calibrate as t_cal, defects as t_df,
                              flows as t_fl, lifetime as t_lt, placement as t_pl,
                              routing as t_rt, serving as t_sv, specs as t_sp,
                              sweep as t_sw, switch as t_swi, workloads as t_wl,
                              yield_study as t_ys)
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.parallel import policy

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "goldens"
CPU = dict(device="cpu")
# the wall-clock fields, the only ones a comparison leaves out
WALL_CLOCK = ("sweep_seconds", "study_seconds")
TRAIN = "train_4k"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the cost model's short float64 vectors (the
    results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(x):
    """``x`` as plain Python values, so that the two packages' objects compare
    with ``==``: a dataclass becomes its class name and fields (those in
    ``WALL_CLOCK`` left out), a set a list sorted by ``repr``, an array or
    tuple a list, NaN the string ``"nan"``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__class__": type(x).__name__,
                **{f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                   if f.name not in WALL_CLOCK}}
    if isinstance(x, dict):
        return [(plain(k), plain(v)) for k, v in x.items() if k not in WALL_CLOCK]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v) for v in x), key=repr)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def outcome(fn, *args, **kw):
    """``plain`` of what ``fn`` returns, or the type name and message of what
    it raises."""
    try:
        return ("ok", plain(fn(*args, **kw)))
    except Exception as e:      # the two packages must raise alike
        return ("raised", type(e).__name__, str(e))


# --------------------------------------------------------------------------
# (i) routing
# --------------------------------------------------------------------------

def flow_sets(P: int, seed: int):
    """Seeded flow sets over ``P`` ports: disjoint all-reduce groups of 2-4
    (what placement produces) and overlapping flows with their own inputs
    and outputs.  Yields ``(kind, [(ips, ops, tag)])``."""
    rnd = random.Random(seed)
    for _ in range(6):
        ports = list(range(P))
        rnd.shuffle(ports)
        flows, i = [], 0
        while i + 2 <= P:
            size = rnd.choice([2, 3, 4])
            grp = sorted(ports[i:i + size])
            i += size
            flows.append((grp, grp, f"d{len(flows)}"))
        yield "disjoint", flows
    for _ in range(6):
        flows = []
        for k in range(rnd.randint(2, 6)):
            ips = rnd.sample(range(P), rnd.randint(1, 4))
            ops = rnd.sample(range(P), rnd.randint(1, 4))
            flows.append((ips, ops, f"o{k}"))
        yield "overlapping", flows


def build_flows(fl, spec):
    return [fl.Flow.make(ips, ops, 0.0, tag) for ips, ops, tag in spec]


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("P", [8, 12, 16])
def test_routing_equals_jax(P, m):
    j_sw_, t_sw_ = j_swi.FredSwitch.build(P, m), t_swi.FredSwitch.build(P, m)
    kinds = set()
    for kind, spec in flow_sets(P, seed=100 * P + m):
        kinds.add(kind)
        jf, tf = build_flows(j_fl, spec), build_flows(t_fl, spec)
        j_adj, t_adj = j_rt.conflict_graph(j_sw_, jf), t_rt.conflict_graph(t_sw_, tf)
        assert plain(t_adj) == plain(j_adj), (kind, spec)
        assert plain(t_rt.color_graph(t_adj, m)) == plain(j_rt.color_graph(j_adj, m))
        got, want = outcome(t_rt.route, t_sw_, tf), outcome(j_rt.route, j_sw_, jf)
        if want[0] == "raised":
            # RoutingConflict's message names the flow count and level
            assert want[1] == "RoutingConflict"
        assert got == want, (kind, spec)
        assert t_rt.routable(t_sw_, tf) == j_rt.routable(j_sw_, jf) == (want[0] == "ok")
    assert kinds == {"disjoint", "overlapping"}


@pytest.mark.parametrize("m", [2, 3])
def test_fig7j_flows_equal_jax(m):
    tf, jf = t_rt.fig7j_flows(), j_rt.fig7j_flows()
    assert plain(tf) == plain(jf)
    sw_t, sw_j = t_swi.FredSwitch.build(8, m), j_swi.FredSwitch.build(8, m)
    assert outcome(t_rt.route, sw_t, tf) == outcome(j_rt.route, sw_j, jf)
    assert t_rt.routable(sw_t, tf) == j_rt.routable(sw_j, jf) == (m == 3)


@pytest.mark.parametrize("n", [8, 12, 16, 20])
def test_strategy_routable_equals_jax(n):
    """Every strategy of ``n`` NPUs under the canonical (MP-consecutive)
    placement: on one FRED_3(n) crossbar, on each (n_groups, group_size)
    shape with and without a given uplink count, and under one seeded
    defect mask."""
    strategies = [(st.mp, st.dp, st.pp) for st in
                  j_sw.strategy_space(n, min_utilization=0.75)]
    assert strategies
    shapes = j_sw.fred_shapes(n)
    jm = j_df.sample_mask(n, dead_npu_rate=0.1, seed=n)
    tm = t_df.sample_mask(n, dead_npu_rate=0.1, seed=n)
    assert plain(tm) == plain(jm)
    seen = set()
    for mp, dp, pp in strategies:
        js, ts = j_pl.Strategy(mp, dp, pp), t_pl.Strategy(mp, dp, pp)
        for shape in [n, *shapes]:
            for kw in ({}, {"uplinks": 2}):
                if not isinstance(shape, tuple) and kw:
                    continue
                for masked in (False, True):
                    jd, td = (jm, tm) if masked else (None, None)
                    want = j_rt.strategy_routable(js, shape, defects=jd, **kw)
                    got = t_rt.strategy_routable(ts, shape, defects=td, **kw)
                    assert got == want, (mp, dp, pp, shape, kw, masked)
                    seen.add(want)
    assert seen == {True, False} or n <= 8


def test_the_reference_f2_draw_routes_in_neither_package():
    """The draw that fails ``tests/test_switch_routing.py::
    test_random_disjoint_flows_route_on_m3`` (the reference's F2, ROADMAP.md
    Queue 3): all-reduce groups [2, 4, 8], [1, 3, 6], [5, 7, 10] and
    [0, 9, 11] on ``FredSwitch.build(12, 3)``.  Both packages say it does not
    route.  A search over every colouring at every level of the recursion,
    with the reference's own ``conflict_graph`` and ``_remap_flow``, finds no
    routing either: under the router's model the draw truly does not route,
    and the test's claim that every disjoint set routes on m = 3 is what is
    wrong for it."""
    groups = ([2, 4, 8], [1, 3, 6], [5, 7, 10], [0, 9, 11])
    jf = [j_fl.all_reduce(g)[0][0] for g in groups]
    tf = [t_fl.all_reduce(g)[0][0] for g in groups]
    assert plain(tf) == plain(jf)
    sw_j, sw_t = j_swi.FredSwitch.build(12, 3), t_swi.FredSwitch.build(12, 3)
    assert j_rt.routable(sw_j, jf) is False
    assert t_rt.routable(sw_t, tf) is False
    assert outcome(t_rt.route, sw_t, tf) == outcome(j_rt.route, sw_j, jf)


def test_check_routing_sweep_at_20_npus_equals_jax():
    got = t_sw.transformer_17b_sweep(20, check_routing=True, **CPU)
    want = j_sw.transformer_17b_sweep(20, check_routing=True)
    assert len(got) == len(want)
    assert [plain(r) for r in got] == [plain(r) for r in want]
    routed = {r.routable for r in got if r.fabric != "baseline"}
    assert routed == {True, False}


# --------------------------------------------------------------------------
# (ii) serving
# --------------------------------------------------------------------------

def test_npu_hbm_bw_is_the_modelled_npus():
    assert t_sv.NPU_HBM_BW == j_sv.NPU_HBM_BW == 3.2e12
    for name in ("DEFAULT_COMPUTE_EFFICIENCY", "BATCH_CANDIDATES",
                 "MAX_SLOT_UTILIZATION", "SLOT_POOL_CAP"):
        assert getattr(t_sv, name) == getattr(j_sv, name), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_terms_equal_jax(arch):
    for prompt, out in ((1024, 256), (128, 32)):
        got = t_sv.model_terms(get_config(arch), t_sv.RequestProfile(prompt, out))
        want = j_sv.model_terms(j_get_config(arch), j_sv.RequestProfile(prompt, out))
        assert plain(got) == plain(want)


@pytest.mark.parametrize("arch", j_as.SERVESWEEP_ARCHS)
def test_phase_plans_and_candidates_equal_jax(arch):
    tp, jp = t_sv.RequestProfile(), j_sv.RequestProfile()
    got = t_sv.phase_plans(get_config(arch), tp)
    want = j_sv.phase_plans(j_get_config(arch), jp)
    assert plain(got) == plain(want)
    assert got[0] and got[1]
    got = t_sv.serving_candidates(get_config(arch), tp, max_wafers=2)
    want = j_sv.serving_candidates(j_get_config(arch), jp, max_wafers=2)
    assert len(got) == len(want) > 0
    assert plain(got) == plain(want)


def test_queueing_equals_jax():
    rnd = random.Random(7)
    for _ in range(40):
        slots = rnd.randint(1, 64)
        service = rnd.uniform(1e-3, 1.0)
        rate = rnd.uniform(0.05, 1.2) * slots / service
        offered = rate * service
        assert t_sv.erlang_c(slots, offered) == j_sv.erlang_c(slots, offered)
        assert plain(t_sv.queue_stats(rate, service, slots)) == \
            plain(j_sv.queue_stats(rate, service, slots))
    for seed, (rate, service, slots) in enumerate(((50.0, 0.05, 4), (900.0, 0.01, 16))):
        kw = dict(base_latency_s=0.003, n_requests=20_000, seed=seed, warmup=500)
        assert t_sv.simulate_traffic(rate, service, slots, **kw) == \
            j_sv.simulate_traffic(rate, service, slots, **kw)


@pytest.fixture(scope="module")
def serving_tables():
    return (t_as.serving_decision_table(**CPU), j_as.serving_decision_table())


def test_serving_decision_table_equals_jax_and_golden(serving_tables):
    got, want = serving_tables
    assert [plain(d) for d in got] == [plain(d) for d in want]
    golden = str(GOLDENS / "servesweep.json")
    assert t_as.check_serving_goldens(got, golden) == []
    assert {d.arch: d.golden() for d in got} == json.loads(pathlib.Path(golden).read_text())


def test_decide_serving_equals_jax():
    obj_t = t_sp.Objective.serving(target_p99_ms=50.0, arrival_rate_rps=2000.0,
                                   prompt_tokens=512, output_tokens=128)
    obj_j = j_sp.Objective.serving(target_p99_ms=50.0, arrival_rate_rps=2000.0,
                                   prompt_tokens=512, output_tokens=128)
    got = outcome(t_sv.decide_serving, get_config("qwen1.5-4b"), obj_t, max_wafers=2)
    want = outcome(j_sv.decide_serving, j_get_config("qwen1.5-4b"), obj_j, max_wafers=2)
    assert got == want and got[0] == "ok"


# --------------------------------------------------------------------------
# (iii) autostrategy
# --------------------------------------------------------------------------

def request(sp, cfg, shape, objective, **kw):
    return sp.DeploymentRequest(model=cfg, shape=shape, objective=objective, **kw)


@pytest.mark.parametrize("kind", ["time", "serving"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_choose_equals_jax(arch, kind):
    t_obj = t_sp.Objective() if kind == "time" else t_as.SERVE_OBJECTIVE
    j_obj = j_sp.Objective() if kind == "time" else j_as.SERVE_OBJECTIVE
    got = outcome(t_as.choose, request(t_sp, get_config(arch), SHAPES_BY_NAME[TRAIN],
                                       t_obj), **CPU)
    want = outcome(j_as.choose, request(j_sp, j_get_config(arch), J_SHAPES[TRAIN], j_obj))
    assert got == want


@pytest.mark.parametrize("kind,error", [("time", "InfeasibleModelError"),
                                        ("serving", "InfeasibleServingError")])
def test_choose_raises_as_jax(kind, error):
    """Where the JAX ``choose`` finds nothing feasible, the port raises the
    same error with the same message."""
    kw = dict(npu_hbm_bytes=2**28)
    if kind == "serving":
        t_obj = t_sp.Objective.serving(target_p99_ms=0.01, concurrent_users=10**6)
        j_obj = j_sp.Objective.serving(target_p99_ms=0.01, concurrent_users=10**6)
    else:
        t_obj, j_obj = t_sp.Objective(), j_sp.Objective()
    got = outcome(t_as.choose, request(t_sp, get_config("arctic-480b"),
                                       SHAPES_BY_NAME[TRAIN], t_obj, **kw), **CPU)
    want = outcome(j_as.choose, request(j_sp, j_get_config("arctic-480b"),
                                        J_SHAPES[TRAIN], j_obj, **kw))
    assert want[:2] == ("raised", error)
    assert got == want


def test_decision_table_meets_the_autostrategy_golden():
    golden = str(GOLDENS / "autostrategy.json")
    archs = [k.split("/")[0] for k in json.loads(pathlib.Path(golden).read_text())]
    got = t_as.decision_table(archs, TRAIN, **CPU)
    assert t_as.check_goldens(got, golden) == []
    assert [plain(d) for d in got] == [plain(d) for d in j_as.decision_table(archs, TRAIN)]


def test_epsweep_decisions_meet_their_golden():
    """Built as ``tests/gen_epsweep_golden.py`` builds them."""
    assert t_as.MOE_ARCHS == j_as.MOE_ARCHS and t_as.EP_SWEEP_KW == j_as.EP_SWEEP_KW
    got = t_as.decision_table(t_as.MOE_ARCHS, **t_as.EP_SWEEP_KW, **CPU)
    want = j_as.decision_table(j_as.MOE_ARCHS, **j_as.EP_SWEEP_KW)
    assert [plain(d) for d in got] == [plain(d) for d in want]
    assert all(d.ep > 1 for d in got)
    assert {f"{d.arch}/{d.shape}": d.golden() for d in got} == \
        json.loads((GOLDENS / "epsweep.json").read_text())


def test_legacy_shim_warns_and_decides_the_same():
    kw = dict(n_npus=32, max_wafers=1, remat="block")
    with pytest.warns(DeprecationWarning, match="choose_strategy"):
        got = t_as.choose_strategy(get_config("llama3.2-1b"), SHAPES_BY_NAME[TRAIN],
                                   **kw, **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = j_as.choose_strategy(j_get_config("llama3.2-1b"), J_SHAPES[TRAIN], **kw)
    direct = t_as.choose(t_as._build_request(get_config("llama3.2-1b"),
                                             SHAPES_BY_NAME[TRAIN], **kw), **CPU)
    assert plain(got) == plain(want) == plain(direct)


def test_goodput_objective_equals_jax():
    t_obj = t_sp.Objective.goodput(mtbf_npu_hours=500.0, goodput_top_k=4)
    j_obj = j_sp.Objective.goodput(mtbf_npu_hours=500.0, goodput_top_k=4)
    kw = dict(n_npus=20, max_wafers=1)
    got = outcome(t_as.choose, request(t_sp, get_config("zamba2-2.7b"),
                                       SHAPES_BY_NAME[TRAIN], t_obj, **kw), **CPU)
    want = outcome(j_as.choose, request(j_sp, j_get_config("zamba2-2.7b"),
                                        J_SHAPES[TRAIN], j_obj, **kw))
    assert got == want and got[0] == "ok"


# --------------------------------------------------------------------------
# (iv) lifetime
# --------------------------------------------------------------------------

def test_checkpoint_math_equals_jax():
    rnd = random.Random(3)
    for _ in range(60):
        ckpt = rnd.choice([0.0, rnd.uniform(0.1, 600.0)])
        restart = rnd.uniform(0.0, 300.0)
        mtbf = rnd.choice([math.inf, rnd.uniform(600.0, 1e7)])
        interval = rnd.choice([0.0, rnd.uniform(1.0, 1e5), math.inf])
        assert t_lt.young_daly_interval(ckpt, mtbf) == j_lt.young_daly_interval(ckpt, mtbf)
        args = (interval, ckpt, restart, mtbf)
        # a zero interval raises, in both packages alike
        assert outcome(t_lt.useful_fraction, *args) == outcome(j_lt.useful_fraction, *args)
        assert outcome(t_lt.time_fractions, *args) == outcome(j_lt.time_fractions, *args)
        assert t_lt.optimal_interval(ckpt, restart, mtbf) == \
            j_lt.optimal_interval(ckpt, restart, mtbf)
    fm_t = t_lt.FailureModel(mtbf_npu_hours=2000.0, mtbf_wafer_hours=9000.0)
    fm_j = j_lt.FailureModel(mtbf_npu_hours=2000.0, mtbf_wafer_hours=9000.0)
    assert fm_t.system_mtbf_s(20, 2) == fm_j.system_mtbf_s(20, 2)


@pytest.fixture(scope="module")
def chains():
    """One degradation chain in each package: the full-wafer MP-heavy
    Transformer-17B deployment of ``tests/test_lifetime.py``, whose first
    death forces a re-plan."""
    out = []
    for pkg, sw, wl, lt, kw in ((j_sw, j_sw, j_wl, j_lt, {}), (t_sw, t_sw, t_wl, t_lt, CPU)):
        skw = dict(n_layers=78, memory=wl.MemoryModel(npu_hbm_bytes=64 * 2**30),
                   min_utilization=0.5)
        feas = [r for r in sw.sweep(sw.transformer_17b, 20, **skw, **kw) if r.feasible]
        winner = min((r for r in feas if r.strategy.mp >= 4 and r.strategy.pp == 1
                      and r.strategy.mp * r.strategy.dp == 20),
                     key=lambda r: r.time_per_sample)
        chain = lt.degradation_chain(sw.transformer_17b, winner, 20, n_states=3, seed=0,
                                     sweep_kw=skw, **kw)
        est = lt.evaluate_candidate(sw.transformer_17b, winner, 20,
                                    failure=lt.FailureModel(mtbf_npu_hours=500.0),
                                    mem=skw["memory"], sweep_kw=skw, **kw)
        out.append((chain, est))
    return out


def test_degradation_chain_equals_jax(chains):
    (j_chain, j_est), (t_chain, t_est) = chains
    assert plain(t_chain) == plain(j_chain)
    assert any(p.source == "fallback" for p in t_chain)
    assert plain(t_est) == plain(j_est)


def test_estimate_and_simulate_lifetime_equal_jax(chains):
    (j_chain, _), (t_chain, _) = chains
    kw = dict(ckpt_write_s=30.0, restart_s=60.0, mtbf_s=50_000.0, mission_s=5_000_000.0)
    assert plain(t_lt.estimate_lifetime(t_chain, **kw)) == \
        plain(j_lt.estimate_lifetime(j_chain, **kw))
    for seed in range(2):
        assert t_lt.simulate_lifetime(t_chain, seed=seed, **kw) == \
            j_lt.simulate_lifetime(j_chain, seed=seed, **kw)


def test_lifetime_pairs_meet_their_golden():
    got = t_as.lifetime_decision_pairs(**CPU)
    assert t_as.check_lifetime_goldens(got, str(GOLDENS / "lifetimesweep.json")) == []
    assert [plain(p) for p in got] == [plain(p) for p in j_as.lifetime_decision_pairs()]


# --------------------------------------------------------------------------
# (v) yield
# --------------------------------------------------------------------------

def test_yield_study_equals_jax():
    kw = dict(n_layers=78, n_masks=8, dead_npu_rate=0.05, seed0=3, check_routing=True)
    got = t_ys.yield_study(t_sw.transformer_17b, 20, **kw, **CPU)
    want = j_ys.yield_study(j_sw.transformer_17b, 20, **kw)
    assert plain(got) == plain(want)
    assert got.golden() == want.golden()
    assert any(not o.survived for o in got.outcomes)


def test_model_yield_study_meets_the_faultsweep_golden():
    got = t_ys.model_yield_study("llama3.2-1b", **CPU)
    want = j_ys.model_yield_study("llama3.2-1b")
    assert plain(got) == plain(want)
    golden = json.loads((GOLDENS / "faultsweep.json").read_text())
    assert got.golden() == golden["llama3.2-1b/train_4k"]


# --------------------------------------------------------------------------
# (vi) calibrate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["calibrated", "low", "high"])
def test_simulate_speedups_equal_jax(point):
    assert t_cal.PAPER_SPEEDUPS == j_cal.PAPER_SPEEDUPS
    assert t_cal.CALIBRATED == j_cal.CALIBRATED
    c = t_cal.CALIBRATED
    args = {"calibrated": (c["compute_efficiency"], c["mesh_step_overhead"],
                           c["fred_step_overhead"]),
            "low": (0.3, 2e-7, 1e-7), "high": (0.7, 2e-6, 8e-7)}[point]
    got, want = t_cal.simulate_speedups(*args), j_cal.simulate_speedups(*args)
    assert got == want
    assert set(got) == set(t_cal.PAPER_SPEEDUPS)
    assert t_cal.loss(got) == j_cal.loss(want)


# --------------------------------------------------------------------------
# (vii) refusals, the policy and the dry run's record
# --------------------------------------------------------------------------

def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, shape = get_config("llama3.2-1b"), SHAPES_BY_NAME[TRAIN]
    with pytest.raises(RuntimeError, match="cuda"):
        t_as.choose(t_sp.DeploymentRequest(model=cfg, shape=shape))
    with pytest.raises(RuntimeError, match="cuda"):
        t_ys.model_yield_study("llama3.2-1b")
    with pytest.raises(RuntimeError, match="cuda"):
        policy.cell_policy(cfg, shape, None, autostrategy=True)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.autostrategy_block(cfg, shape)


def as_dicts(pcfg, ocfg):
    return dataclasses.asdict(pcfg), dataclasses.asdict(ocfg)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "arctic-480b"])
def test_cell_policy_autostrategy_equals_jax(arch):
    got = policy.cell_policy(get_config(arch), SHAPES_BY_NAME[TRAIN], None,
                             autostrategy=True, **CPU)
    want = j_policy.cell_policy(j_get_config(arch), J_SHAPES[TRAIN], None,
                                autostrategy=True)
    assert as_dicts(*got) == as_dicts(*want)
    assert got[0].auto_strategy.is_set


def jax_autostrategy_block(cfg, shape):
    """The JAX dry run's ``"autostrategy"`` block for the cell: the ``if
    autostrategy:`` branch of ``repro.launch.dryrun.run_cell``, read out of its
    source and run alone (the module sets ``XLA_FLAGS`` on import, and its
    ``run_cell`` compiles the step)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    branch = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                  and isinstance(n.test, ast.Name) and n.test.id == "autostrategy")
    scope = {"cfg": cfg, "shape": shape}
    exec(compile(ast.Module(body=branch.body, type_ignores=[]), "dryrun.py", "exec"), scope)
    return scope["auto_rec"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "arctic-480b"])
def test_dryrun_autostrategy_block_equals_jax(arch):
    decision, got = dryrun.autostrategy_block(get_config(arch), SHAPES_BY_NAME[TRAIN], **CPU)
    want = jax_autostrategy_block(j_get_config(arch), J_SHAPES[TRAIN])
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in WALL_CLOCK} == \
        {k: v for k, v in want.items() if k not in WALL_CLOCK}
    assert got["sweep_seconds"] >= 0
    golden = json.loads((GOLDENS / "autostrategy.json").read_text())
    assert decision.golden() == golden[f"{arch}/{TRAIN}"]
