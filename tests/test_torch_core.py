"""FRED's cost model in the port (``repro_torch.core``) against the JAX
package's (``repro.core``), on the CPU, with no tolerance: every comparison
is ``==``.

References:

(i)   200 seeded cases (``draw_sim_case``: a fabric, a wafer shape, a wafer
      count with its inter topology and stacking, a strategy with ep / sp,
      a random workload), each built once in each package from the same
      draws: the port's scalar ``Simulator.run`` equals the JAX one
      (``as_dict()``, ``dp_levels``), and the port's
      ``BatchEngine(device="cpu").run_batch`` equals the JAX ``BatchEngine``;
(ii)  200 seeded memory cases: ``memory_bytes_batch`` / ``feasible_batch``
      equal the JAX ones and the port's scalar ``memory_bytes_per_npu``;
(iii) the structure twins (``_ring_structures_np``, ``_span_structures_np``,
      ``MeshFabric.ring_structure``, ``FredFabric.span_structure``) equal the
      JAX ones;
(iv)  the sweeps of ``tests/test_batch_engine.py``'s fixed cases, its MoE-EP
      case and ``tests/test_defects.py``'s masked sweep: the port's batched
      sweep equals the JAX batched sweep result by result and in Pareto
      membership; the port's ``transformer_17b_sweep(512)`` front equals
      ``tests/goldens/sweep512_pareto.json``;
(v)   ``from_model_config`` of every architecture at every shape kind, and
      each copied module's public names;
(vi)  the refusals: ``BatchEngine`` / ``feasible_batch`` / ``sweep`` with no
      device and no CUDA; ``sweep(check_routing=True)``'s ``routable``
      equal to the JAX sweep's; and the copies of one ``run_batch`` (two to
      the device, one back).
"""

import dataclasses
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import (batch_engine as j_be, cluster as j_cl, defects as j_df,
                        fabric as j_fa, flows as j_fl, meshnet as j_mn,
                        placement as j_pl, simulator as j_si, specs as j_sp,
                        sweep as j_sw, switch as j_swi, workloads as j_wl)
from repro.models.config import SHAPES_BY_NAME as J_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import (batch_engine as t_be, cluster as t_cl, defects as t_df,
                              fabric as t_fa, flows as t_fl, meshnet as t_mn,
                              placement as t_pl, simulator as t_si, specs as t_sp,
                              sweep as t_sw, switch as t_swi, workloads as t_wl)
from repro_torch.models.config import SHAPES_BY_NAME
from tests.test_batch_engine import ALL_FABRICS, GOLDEN, _front_rows, random_memory_model

JAX = SimpleNamespace(be=j_be, cl=j_cl, df=j_df, fa=j_fa, mn=j_mn, pl=j_pl, si=j_si,
                      sp=j_sp, sw=j_sw, wl=j_wl)
PORT = SimpleNamespace(be=t_be, cl=t_cl, df=t_df, fa=t_fa, mn=t_mn, pl=t_pl, si=t_si,
                       sp=t_sp, sw=t_sw, wl=t_wl)
CPU = dict(device="cpu")


# --------------------------------------------------------------------------
# seeded cases, drawn once and built in each package
# --------------------------------------------------------------------------

def draw_sim_case(rng: random.Random) -> dict:
    """The draws of ``tests/test_batch_engine.py::random_sim_case`` as plain
    values: every branch of the cost model reachable."""
    fabric = rng.choice(ALL_FABRICS)
    a, b = rng.randint(1, 8), rng.randint(1, 8)
    npw = a * b
    n_wafers = rng.choice((1, 2, 3, 4, 6))
    wafers = rng.randint(1, n_wafers)
    for _ in range(64):
        mp, pp, dpw = rng.randint(1, 4), rng.randint(1, 3), rng.randint(1, 4)
        if mp * pp * dpw <= npw:
            break
    else:
        mp = pp = dpw = 1
    ep = rng.choice([d for d in (1, 2, 3, 4) if dpw % d == 0])
    sp = rng.choice([d for d in (1, 2, 3) if mp % d == 0])
    work = dict(
        name="rand", n_layers=rng.randint(pp, 60),
        params_per_layer=rng.uniform(1e3, 1e10),
        flops_fwd_per_sample_layer=rng.uniform(1e3, 1e12),
        act_bytes_per_sample=rng.uniform(1.0, 1e7),
        execution=rng.choice(("stationary", "streaming")),
        mp_allreduce_per_layer=rng.randint(0, 2),
        samples_per_dp=rng.randint(1, 64),
        seq=rng.randint(1, 64),
        kv_bytes_per_sample_layer=rng.uniform(0.0, 1e5),
        a2a_bytes_per_sample_layer=rng.choice((0.0, rng.uniform(1.0, 1e6))),
        expert_param_fraction=rng.uniform(0.0, 0.95))
    cluster = None
    if n_wafers > 1:
        cluster = dict(n_wafers=n_wafers,
                       inter_wafer_links=rng.randint(1, 64),
                       inter_wafer_bw=rng.uniform(1e9, 1e12),
                       inter_topology=rng.choice(j_cl.INTER_TOPOLOGIES),
                       hierarchy=rng.choice(j_sw.hierarchy_specs(n_wafers, 2)))
    return dict(fabric=fabric, shape=(a, b), n_io=rng.randint(1, 32),
                overlap=rng.choice((0.0, rng.uniform(0.0, 1.0))),
                strategy=dict(mp=mp, dp=dpw * wafers, pp=pp, wafers=wafers, ep=ep,
                              sp=sp),
                work=work, cluster=cluster)


def build_sim_case(core, case):
    """(Simulator, Workload) of ``case`` in the package ``core``."""
    w = core.wl.Workload(strategy=core.pl.Strategy(**case["strategy"]), **case["work"])
    cspec = core.sp.ClusterSpec(**case["cluster"]) if case["cluster"] else None
    sim = core.si.Simulator(case["fabric"], comm_overlap_fraction=case["overlap"],
                            spec=core.sp.FabricSpec(mesh_shape=case["shape"],
                                                    fred_shape=case["shape"],
                                                    n_io=case["n_io"]),
                            cluster_spec=cspec)
    return sim, w


def sim_cases(seed, n=200):
    rng = random.Random(seed)
    return [draw_sim_case(rng) for _ in range(n)]


# --------------------------------------------------------------------------
# (i) the scalar simulator and the batched engine
# --------------------------------------------------------------------------

def test_scalar_simulator_equals_jax_seeded():
    for i, case in enumerate(sim_cases(0)):
        (jsim, jw), (tsim, tw) = build_sim_case(JAX, case), build_sim_case(PORT, case)
        want, got = jsim.run(jw), tsim.run(tw)
        assert got.as_dict() == want.as_dict(), i
        assert got.dp_levels == want.dp_levels, i


def test_batch_engine_equals_jax_seeded():
    """One candidate a call, as the JAX package's seeded test runs it; the
    port's engine also equals the port's scalar oracle."""
    for i, case in enumerate(sim_cases(0)):
        (jsim, jw), (tsim, tw) = build_sim_case(JAX, case), build_sim_case(PORT, case)
        want = j_be.BatchEngine(jsim).run_batch([jw])[0]
        got = t_be.BatchEngine(tsim, **CPU).run_batch([tw])[0]
        assert got.as_dict() == want.as_dict(), i
        assert got.dp_levels == want.dp_levels, i
        assert got.as_dict() == tsim.run(tw).as_dict(), i


def test_batch_engine_lanes_equal_jax_on_one_fabric():
    """Many strategies in one call (the sweep's shape of call): every
    strategy that fits a 4x6 wafer of 3, with random workloads, per fabric."""
    rng = random.Random(7)
    for fabric in ALL_FABRICS:
        cases = []
        for st in j_sw.strategy_space(24, n_layers=40, min_utilization=0.0):
            case = draw_sim_case(rng)
            case["strategy"] = dict(mp=st.mp, dp=st.dp, pp=st.pp, wafers=1, ep=1, sp=1)
            case["work"]["n_layers"] = max(case["work"]["n_layers"], st.pp)
            cases.append(case)
        out = []
        for core in (JAX, PORT):
            sim = core.si.Simulator(fabric, spec=core.sp.FabricSpec(
                mesh_shape=(4, 6), fred_shape=(4, 6), n_io=8),
                cluster_spec=core.sp.ClusterSpec(n_wafers=3, inter_topology="switch"))
            ws = [build_sim_case(core, c)[1] for c in cases]
            engine = (core.be.BatchEngine(sim, **CPU) if core is PORT
                      else core.be.BatchEngine(sim))
            out.append([(b.as_dict(), b.dp_levels) for b in engine.run_batch(ws)])
        assert out[1] == out[0], fabric


# --------------------------------------------------------------------------
# (ii) the memory model
# --------------------------------------------------------------------------

def test_memory_batch_equals_jax_seeded():
    rng = random.Random(1)
    for i in range(200):
        case = draw_sim_case(rng)
        jmem = random_memory_model(rng)
        tmem = t_wl.MemoryModel(**dataclasses.asdict(jmem))
        jw, tw = build_sim_case(JAX, case)[1], build_sim_case(PORT, case)[1]
        want, want_ok = j_be.feasible_batch([jw], jmem)
        got, got_ok = t_be.feasible_batch([tw], tmem, **CPU)
        assert got.tolist() == want.tolist(), i
        assert got_ok.tolist() == want_ok.tolist(), i
        assert t_be.memory_bytes_batch([tw], tmem, **CPU).tolist() == want.tolist(), i
        assert float(got[0]) == t_wl.memory_bytes_per_npu(tw, tmem), i
        assert t_wl.is_feasible(tw, tmem) == j_wl.is_feasible(jw, jmem), i


def test_memory_batch_equals_jax_on_paper_workloads():
    for training in (True, False):
        jmem = j_wl.MemoryModel(training=training)
        tmem = t_wl.MemoryModel(training=training)
        want = j_be.memory_bytes_batch(j_wl.paper_workloads(), jmem)
        got = t_be.memory_bytes_batch(t_wl.paper_workloads(), tmem, **CPU)
        assert got.tolist() == want.tolist()


# --------------------------------------------------------------------------
# (iii) the structure twins
# --------------------------------------------------------------------------

def test_ring_structures_equal_jax_seeded():
    rng = random.Random(2)
    for _ in range(300):
        rows, cols = rng.randint(1, 24), rng.randint(1, 24)
        stride, count = rng.randint(1, 16), rng.randint(2, 32)
        if (count - 1) * stride >= rows * cols:
            continue
        want = j_be._ring_structures_np(rows, cols, np.array([count]), np.array([stride]))
        got = t_be._ring_structures_np(rows, cols, np.array([count]), np.array([stride]))
        assert got == want
        group = t_pl.strided_group(count, stride)
        assert t_mn.MeshFabric(rows=rows, cols=cols).ring_structure(group) == \
            j_mn.MeshFabric(rows=rows, cols=cols).ring_structure(group) == want[0]


def test_span_structures_equal_jax_seeded():
    rng = random.Random(4)
    for _ in range(300):
        gs, count, stride = rng.randint(1, 16), rng.randint(2, 64), rng.randint(1, 16)
        want = j_be._span_structures_np(gs, np.array([count]), np.array([stride]))
        got = t_be._span_structures_np(gs, np.array([count]), np.array([stride]))
        assert got == want
        n_groups = (count - 1) * stride // gs + 1
        group = t_pl.strided_group(count, stride)
        assert t_fa.FredFabric(t_fa.CONFIGS["FRED-C"], n_groups=n_groups,
                               group_size=gs).span_structure(group) == want[0]


# --------------------------------------------------------------------------
# (iv) the sweeps
# --------------------------------------------------------------------------

def t17b(core):
    return lambda st: core.wl.transformer("T17B", 78, 4256, 1024, st, "stationary")


def gpt3(core):
    return lambda st: core.wl.transformer("GPT-3", 96, 12288, 2048, st, "streaming")


def moe_t17b(core):
    """T17B with mixtral-style expert annotations (``tests/test_batch_engine.py``)."""
    def fn(st):
        w = core.wl.transformer("T17B-moe", 78, 4256, 1024, st, "stationary")
        return dataclasses.replace(w, a2a_bytes_per_sample_layer=2 * 4256 * 2.0,
                                   expert_param_fraction=0.8)
    return fn


def result_row(r):
    return (r.fabric, r.shape, dataclasses.astuple(r.strategy), r.n_wafers, r.hierarchy,
            r.inter_topology, r.minibatch, r.param_bytes_per_npu, r.breakdown.as_dict(),
            r.breakdown.dp_levels, r.memory_bytes_per_npu, r.feasible, r.pareto,
            r.inter_wafer_bw, r.routable, r.defect_rate, r.defect_seed, r.degraded_time_s)


def assert_sweeps_equal(got, want):
    assert want and len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert result_row(g) == result_row(w), i
    assert t_sw.to_csv_rows(got) == j_sw.to_csv_rows(want)


def masked(core):
    return core.df.sample_mask(20, dead_npu_rate=0.1, dead_link_rate=0.05, seed=5,
                               mesh_shape=(5, 4))


SWEEPS = {
    "20-two-wafers": (t17b, dict(n_npus=20, max_wafers=2)),
    "16-all-fabrics": (t17b, dict(n_npus=16, fabrics=ALL_FABRICS)),
    "20-two-wafers-memory": (t17b, dict(n_npus=20, max_wafers=2, memory="default")),
    "24-three-wafers-pruned": (t17b, dict(n_npus=24, max_wafers=3, prune_symmetric=True)),
    "gpt3-20-two-wafers": (gpt3, dict(n_npus=20, max_wafers=2)),
    "gpt3-16-all-fabrics": (gpt3, dict(n_npus=16, fabrics=ALL_FABRICS)),
    "gpt3-20-two-wafers-memory": (gpt3, dict(n_npus=20, max_wafers=2, memory="default")),
    "gpt3-24-three-wafers-pruned": (gpt3, dict(n_npus=24, max_wafers=3,
                                               prune_symmetric=True)),
    "moe-ep-sp-overlap": (moe_t17b, dict(n_npus=20, max_wafers=2, memory="default",
                                         ep_candidates=(1, 2, 4), sp_candidates=(1, 2),
                                         comm_overlap_fraction=0.3)),
    "masked-wafer": (t17b, dict(n_npus=20, min_utilization=0.5, defects=masked)),
    "two-levels-every-topology": (t17b, dict(
        n_npus=8, max_wafers=4, max_levels=2,
        inter_topologies=("ring", "fully_connected", "switch"), memory="inference")),
}


def sweep_kwargs(core, kw):
    kw = dict(kw)
    n_layers = 96 if "gpt3" in kw.pop("_name", "") else 78
    if kw.get("memory") == "default":
        kw["memory"] = core.wl.MemoryModel()
    elif kw.get("memory") == "inference":
        kw["memory"] = core.wl.MemoryModel(training=False)
    if "defects" in kw:
        kw["defects"] = kw["defects"](core)
    return dict(n_layers=n_layers, **kw)


@pytest.mark.parametrize("case", list(SWEEPS))
def test_batched_sweep_equals_jax(case):
    fn, kw = SWEEPS[case]
    kw = dict(kw, _name=case)
    want = j_sw.sweep(fn(JAX), engine="batched", **sweep_kwargs(JAX, kw))
    got = t_sw.sweep(fn(PORT), engine="batched", **sweep_kwargs(PORT, kw), **CPU)
    assert_sweeps_equal(got, want)


def test_scalar_sweep_equals_the_batched_one():
    kw = dict(n_layers=78, max_wafers=2, memory=t_wl.MemoryModel(),
              ep_candidates=(1, 2), comm_overlap_fraction=0.3)
    got = t_sw.sweep(moe_t17b(PORT), 20, engine="batched", **kw, **CPU)
    want = t_sw.sweep(moe_t17b(PORT), 20, engine="scalar", **kw)
    assert [result_row(r) for r in got] == [result_row(r) for r in want]


def test_sweep512_front_equals_the_golden():
    res = t_sw.transformer_17b_sweep(512, engine="batched", **CPU)
    assert len(res) == 17917
    assert _front_rows(res) == json.loads(GOLDEN.read_text())


# --------------------------------------------------------------------------
# (v) the workload adapter and the copies' names
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_from_model_config_equals_jax(arch):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for mp, dp in ((1, 1), (2, 4), (8, 2)):
            got = t_wl.from_model_config(get_config(arch), SHAPES_BY_NAME[shape],
                                         t_pl.Strategy(mp, dp, 1))
            want = j_wl.from_model_config(jax_get_config(arch), J_SHAPES[shape],
                                          j_pl.Strategy(mp, dp, 1))
            g, w = dataclasses.asdict(got), dataclasses.asdict(want)
            assert g == w, (arch, shape)
            assert got.param_bytes_total == want.param_bytes_total


COPIES = {"flows": (t_fl, j_fl), "switch": (t_swi, j_swi), "defects": (t_df, j_df),
          "placement": (t_pl, j_pl), "workloads": (t_wl, j_wl), "specs": (t_sp, j_sp),
          "fabric": (t_fa, j_fa), "meshnet": (t_mn, j_mn), "cluster": (t_cl, j_cl),
          "simulator": (t_si, j_si), "sweep": (t_sw, j_sw), "batch_engine": (t_be, j_be)}


@pytest.mark.parametrize("name", list(COPIES))
def test_the_copy_has_every_public_name(name):
    port, ref = COPIES[name]
    public = lambda m: {k for k, v in vars(m).items()
                        if not k.startswith("_") and getattr(v, "__module__", m.__name__)
                        == m.__name__}
    assert public(ref) <= public(port), public(ref) - public(port)


def test_the_modelled_constants_are_the_references():
    assert t_si.NPU_PEAK_FLOPS == j_si.NPU_PEAK_FLOPS
    assert t_wl.DEFAULT_NPU_HBM_BYTES == j_wl.DEFAULT_NPU_HBM_BYTES
    assert {k: dataclasses.astuple(v) for k, v in t_fa.CONFIGS.items()} == \
        {k: dataclasses.astuple(v) for k, v in j_fa.CONFIGS.items()}
    assert dataclasses.astuple(t_mn.MeshFabric()) == dataclasses.astuple(j_mn.MeshFabric())


# --------------------------------------------------------------------------
# (vi) the refusals and the copies of one run
# --------------------------------------------------------------------------

def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim, w = build_sim_case(PORT, sim_cases(3, 1)[0])
    with pytest.raises(RuntimeError, match="cuda"):
        t_be.BatchEngine(sim)
    with pytest.raises(RuntimeError, match="cuda"):
        t_be.feasible_batch([w], t_wl.MemoryModel())
    with pytest.raises(RuntimeError, match="cuda"):
        t_sw.transformer_17b_sweep(16)
    assert t_sw.transformer_17b_sweep(16, engine="scalar")    # the oracle needs no device


def test_check_routing_waits_for_m12b():
    """``sweep(check_routing=True)`` fills ``routable`` as the JAX sweep does,
    result by result.  (The name is historical: the port's sweep refused
    ``check_routing`` until it had its copy of the switch router.)"""
    got = t_sw.transformer_17b_sweep(16, check_routing=True, **CPU)
    want = j_sw.transformer_17b_sweep(16, check_routing=True)
    assert [r.routable for r in got] == [r.routable for r in want]
    assert {r.routable for r in got if r.fabric != "baseline"} <= {True, False}
    assert any(r.routable is not None for r in got)
    assert all(r.routable is None for r in got if r.fabric == "baseline")


def test_one_run_copies_twice_in_and_once_out():
    case = sim_cases(5, 1)[0]
    case["cluster"] = dict(n_wafers=2)
    case["strategy"] = dict(mp=1, dp=2, pp=1, wafers=2, ep=1, sp=1)
    for fabric in ("baseline", "FRED-D"):
        case["fabric"] = fabric
        sim, w = build_sim_case(PORT, case)
        engine = t_be.BatchEngine(sim, **CPU)
        engine.run_batch([w] * 5)
        assert engine.copies == {"h2d": 2, "d2h": 1}
