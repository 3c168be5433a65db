"""The port's launch tools (``repro_torch.launch.{roofline,dryrun,perf}``,
``launch.mesh.count_collectives``, ``configs.registry.cells``) on the CPU.

* ``shape_applicability`` / ``cells``, ``param_counts``, ``model_flops``,
  ``exposed_comm_s``, ``roofline_terms`` and ``corrected_totals`` equal the
  JAX functions (the JAX hardware constants monkeypatched to the port's H100
  ones for ``roofline_terms``; ``corrected_totals`` and ``perf.PLAN`` read
  out of the JAX sources, whose modules set ``XLA_FLAGS`` on import).
* ``count_collectives`` equals a hand reckoning for each schedule and
  transport primitive on a ``StackedMesh`` (2, 2, 2), and one spawned world
  of 4 ``gloo`` ranks (``DistMesh`` (1, 2, 2), ``tools/count_parity.py``)
  counts what a ``StackedMesh`` of that shape counts, per device: each
  primitive, and a whole train step, prefill and decode step of an fsdp +
  TP, an EP and an SSM setup; its ``count_cost`` per device against the
  stacked run's over its ranks, in the bounds ``PERF.md`` states.
* ``count_cost``: one product's 2mnk FLOPs and its bytes; the kernels'
  formulas for ``ops.attention`` / ``ops.ssd`` forward and backward.
* The probe: ``corrected_totals`` of the L1 / L2 runs equals the counted
  full depth exactly, at the JAX mini dry run's shapes.
* ``memory_per_device``'s argument bytes equal the JAX setup's specs' over
  the production meshes; ``ep_compare`` equals JAX's (one subprocess on 8
  host devices), ``serving_compare`` has the JAX record's form and its
  analytical column; ``run_cell(autostrategy=True)`` reaches the setup with
  the JAX policy's stamped strategy; the CLIs refuse to run without a GPU.
"""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.launch.roofline as j_roofline
import repro.parallel.sharding as j_sharding
import repro.parallel.steps as j_steps
from repro.configs import registry as j_registry
from repro.models import transformer as jtfm
from repro.models.config import SHAPES as J_SHAPES
from repro.parallel import policy as j_policy
from repro.train import optim as j_optim

from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_bwd_work, flash_fwd_work
from repro_torch.kernels.ssd_scan import ssd_bwd_work, ssd_fwd_work
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch.mesh import StackedMesh, count_collectives, make_production_mesh
from repro_torch.models.config import SHAPES, ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel import steps
from repro_torch.parallel.policy import cell_policy

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
JAX_LAUNCH = ROOT / "src" / "repro" / "launch"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (the gloo ranks
    run one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_source(name: str, what: str):
    """``what`` (a function or an assignment) of ``src/repro/launch/<name>``,
    without importing the module."""
    src = (JAX_LAUNCH / name).read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef) and node.name == what:
            ns = {}
            exec(ast.get_source_segment(src, node), ns)
            return ns[what]
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == what:
            return ast.literal_eval(node.value)
    raise KeyError(what)


# --------------------------------------------------------------------------
# the pure functions against JAX
# --------------------------------------------------------------------------

def test_cells_equal_jax():
    got = [(a, s.name, ok, why) for a, _, s, ok, why in registry.cells()]
    want = [(a, s.name, ok, why) for a, _, s, ok, why in j_registry.cells()]
    assert got == want and len(got) == 40
    assert sum(not ok for *_, ok, _ in got) == 7        # long_500k on quadratic attention


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_counts_and_model_flops_equal_jax(arch):
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    assert roofline.param_counts(cfg) == j_roofline.param_counts(jcfg)
    for shape, jshape in zip(SHAPES, J_SHAPES):
        assert registry.shape_applicability(cfg, shape) == \
            j_registry.shape_applicability(jcfg, jshape)
        assert roofline.model_flops(cfg, shape) == j_roofline.model_flops(jcfg, jshape)


def test_exposed_comm_s_equals_jax():
    for comm in (0.0, 0.5, 1.0, 3.25, 1e-9):
        for over in (0.0, 0.25, 1.0, 7.5):
            assert roofline.exposed_comm_s(comm, over) == j_roofline.exposed_comm_s(comm, over)


def synthetic_records():
    """Records as run_cell writes them, with and without corrected totals."""
    l1 = {"cost": {"flops": 3.0e12, "bytes accessed": 4.0e10}, "collective_bytes": 7.0e8}
    l2 = {"cost": {"flops": 5.5e12, "bytes accessed": 6.5e10}, "collective_bytes": 9.5e8}
    base = {"n_devices": 4, "cost_analysis": {"flops": 9.0e13, "bytes accessed": 2.0e12},
            "collectives": {"total_bytes": 4.0e10}}
    return [dict(base), dict(base, probe={"L1": l1, "L2": l2}),
            dict(base, probe={"L1": l1, "L2": dict(l2, collective_bytes=1.0e8)}),
            dict(base, n_devices=256)]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-medium", "mixtral-8x7b",
                                  "llama3.2-1b"])
def test_roofline_terms_and_corrected_totals_equal_jax(arch, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(j_roofline, name, getattr(roofline, name))
    j_corrected = jax_source("dryrun.py", "corrected_totals")
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    for rec in synthetic_records():
        rec["corrected"] = dryrun.corrected_totals(rec, cfg)
        assert rec["corrected"] == j_corrected(rec, jcfg)
        for shape, jshape in zip(SHAPES, J_SHAPES):
            for frac in (0.0, 0.5):
                assert roofline.roofline_terms(rec, cfg, shape, frac) == \
                    j_roofline.roofline_terms(rec, jcfg, jshape, frac)


def test_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_perf_plan_equals_jax():
    want = [(a, s, v, o) for a, s, v, _, o in jax_source("perf.py", "PLAN")]
    assert [(a, s, v, o) for a, s, v, _, o in perf.PLAN] == want and len(want) == 13


# --------------------------------------------------------------------------
# the collectives' bytes
# --------------------------------------------------------------------------

# ``tools/count_parity.py`` runs each schedule and primitive and three setups'
# steps once stacked and once in a world of 4 gloo ranks
_spec = importlib.util.spec_from_file_location("count_parity", ROOT / "tools" / "count_parity.py")
count_parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(count_parity)


def hand_reckoning(P, D, M):
    """Per-device bytes by kind, fp32, of ``collective_counts``'s cases on a
    (pod P, data D, model M) mesh: each call's bytes are one rank's output; a
    collective over one rank moves nothing."""
    n = count_parity.N
    return {
        # reduce-scatter over every rank (the exchange: n values arrive) and
        # the all-gather of the n / PDM shard back to n
        "flat_all_reduce": {"all-to-all": 4 * n, "all-gather": 4 * n},
        # exchange over data (n), gather of the n / D shard over pod (P n / D),
        # gather over data (n)
        "hierarchical_all_reduce": {"all-to-all": 4 * n,
                                    "all-gather": 4 * (P * n // D * (P > 1) + n)},
        # a (4, 6) leaf with its rows over data: the exchange of every block
        # (24 values), then the all-reduce over pod of the rank's block
        # (24 / D values) as a gather of P of them
        "build_shard_sync": {"all-to-all": 4 * 24,
                             **({"all-gather": 4 * P * 24 // D} if P > 1 else {})},
        # (D, 3) blocks a rank, forward and backward
        "all_to_all": {"all-to-all": 2 * 4 * D * 3},
        # 5 values a rank, forward and backward (a shift by one along model)
        "ppermute": {"collective-permute": 2 * 4 * 5},
        # forward: the whole (3, 4 M); backward: one all-reduce of it over model
        "gather_from_tp": {"all-gather": 2 * 4 * 12 * M, "all-to-all": 4 * 12 * M},
    }


def test_count_collectives_equals_the_hand_reckoning():
    mesh = StackedMesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    got = count_parity.collective_counts(mesh)
    for case, want in hand_reckoning(2, 2, 2).items():
        assert got[case]["per_kind_bytes"] == want, case
        assert got[case]["total_bytes"] == sum(want.values()), case


def test_count_collectives_is_off_outside_a_count():
    mesh = StackedMesh((2, 2), ("data", "model"), "cpu")
    count_parity.flat_all_reduce(torch.randn(2, 2, 8), mesh, ("data", "model"))
    with count_collectives() as c:
        pass
    assert c == {"per_kind_bytes": {}, "total_bytes": 0, "op_count": 0}


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """The stacked run and a world of 4 gloo ranks (pod 1, data 2, model 2)."""
    return count_parity.run(str(tmp_path_factory.mktemp("gloo")))


def test_a_gloo_world_counts_what_the_stacked_mesh_counts(gloo_world):
    stacked = gloo_world["stacked"]
    want = hand_reckoning(1, 2, 2)
    for rank, got in enumerate(gloo_world["ranks"]):
        for case, rec in got["primitives"].items():
            assert rec == stacked["primitives"][case], (rank, case)
            assert rec["per_kind_bytes"] == want[case], (rank, case)
        # whole steps of fsdp + TP, zero1 + TP, EP and the SSM under TP: the
        # stacked mesh's ranks in turn (and an EP group's lanes) count a
        # rank's share
        assert len(got["setups"]) == len(count_parity.SETUPS) * 3
        for step, rec in got["setups"].items():
            assert rec["collectives"] == stacked["setups"][step]["collectives"], (rank, step)
            assert rec["collectives"]["total_bytes"] > 0


def test_a_gloo_rank_counts_the_stacked_cost_over_its_ranks(gloo_world):
    """``count_cost`` per device: a DistMesh rank against the stacked run
    over its ranks.  Prefill and decode FLOPs of the dense and SSM setups
    are equal; the rest differs by what one transport runs and the other
    does not, in the bounds ``PERF.md`` states: a train step's remat rerun
    stops one product earlier on a rank, EP's lanes share work on the
    stacked mesh, and a replicated operand or state is held (and read) once
    there, each rank's own on a DistMesh."""
    stacked = gloo_world["stacked"]["setups"]
    for got in gloo_world["ranks"]:
        for step, rec in got["setups"].items():
            s = stacked[step]
            if not step.startswith("mixtral") and not step.endswith("train"):
                assert rec["flops"] == s["flops"], step
            assert 0.97 <= rec["flops"] / s["flops"] <= 1.01, step
            assert 0.65 <= rec["bytes"] / s["bytes"] <= 1.35, step


# --------------------------------------------------------------------------
# FLOPs and bytes
# --------------------------------------------------------------------------

def test_count_cost_of_one_product():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with roofline.count_cost() as c:
        torch.matmul(a, b)
    assert c == {"flops": 2 * 8 * 16 * 4, "bytes accessed": (8 * 16 + 16 * 4 + 8 * 4) * 4}
    with roofline.count_cost(ranks=4) as c:
        torch.matmul(a, b)
    assert c["flops"] == 2 * 8 * 16 * 4 / 4


def test_count_cost_counts_views_as_nothing_and_an_expand_once():
    a = torch.randn(4, 1, 8)
    with roofline.count_cost() as c:
        b = a.transpose(0, 1).reshape(1, 32)
        e = a.expand(4, 16, 8)
        s = e + 1.0
    assert c["flops"] == 0
    # b: a view; the sum reads a's 32 values once and writes 512
    assert c["bytes accessed"] == (32 + 4 * 16 * 8) * 4
    assert b.shape == (1, 32) and s.shape == (4, 16, 8)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_attention_counts_the_kernels_formula_forward_and_backward(causal, window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 70, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 70, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 70, 2, 16, generator=g, requires_grad=True)
    do = torch.randn(2, 70, 4, 16, generator=g)
    with roofline.count_cost() as fwd:
        out = ops.attention(q, k, v, causal=causal, window=window)
    with roofline.count_cost() as bwd:
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    lse = torch.empty(2, 4, 70)
    assert (fwd["flops"], fwd["bytes accessed"]) == \
        flash_fwd_work(q, k, v, out, lse, causal=causal, window=window)
    assert (bwd["flops"], bwd["bytes accessed"]) == \
        flash_bwd_work(q, k, v, out, do, lse, dq, dk, dv, causal=causal, window=window)
    with torch.no_grad(), roofline.count_cost() as inf:
        out = ops.attention(q, k, v, causal=causal, window=window)
    assert (inf["flops"], inf["bytes accessed"]) == \
        flash_fwd_work(q, k, v, out, causal=causal, window=window)


def test_ssd_counts_the_kernels_formula_forward_and_backward():
    g = torch.Generator().manual_seed(1)
    B, S, H, hd, N, G = 2, 100, 4, 16, 8, 2
    x = torch.randn(B, S, H, hd, generator=g, requires_grad=True)
    dt = torch.rand(B, S, H, generator=g).requires_grad_()
    A = (-torch.rand(H, generator=g)).requires_grad_()
    Bm = torch.randn(B, S, G, N, generator=g, requires_grad=True)
    Cm = torch.randn(B, S, G, N, generator=g, requires_grad=True)
    dy = torch.randn(B, S, H, hd, generator=g)
    with roofline.count_cost() as fwd:
        y, final = ops.ssd(x, dt, A, Bm, Cm, return_state=True)
    with roofline.count_cost() as bwd:
        grads = torch.autograd.grad(y, (x, dt, A, Bm, Cm), dy)
    assert (fwd["flops"], fwd["bytes accessed"]) == \
        ssd_fwd_work(x, dt, A, Bm, Cm, None, y, final)
    assert (bwd["flops"], bwd["bytes accessed"]) == \
        ssd_bwd_work(x, dt, A, Bm, Cm, None, dy, (*grads, None))
    assert fwd["flops"] > 0 and bwd["flops"] > fwd["flops"]


# --------------------------------------------------------------------------
# the probe, the placement, the tools
# --------------------------------------------------------------------------

# the JAX mini dry run's shapes (tests/test_multidevice.py), 4 layers (8 for
# zamba2, whose attn_every is 2): the full depth is not the L2 probe itself
MINI = [("llama3.2-1b", 4), ("mixtral-8x7b", 4), ("mamba2-1.3b", 4), ("zamba2-2.7b", 8)]
MINI_SHAPES = [ShapeConfig("t", "train", 64, 4), ShapeConfig("d", "decode", 64, 4)]


@pytest.mark.parametrize("arch,layers", MINI, ids=[a for a, _ in MINI])
def test_the_probe_is_exact(arch, layers):
    mesh = StackedMesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    cfg = registry.get_config(arch).reduced(num_layers=layers)
    for shape in MINI_SHAPES:
        pcfg, ocfg = cell_policy(cfg, shape, mesh)
        full = dryrun.measure_step(cfg, shape, mesh, pcfg, ocfg, timed=1)
        rec = {"probe": dryrun.probe_layer_cost(cfg, shape, mesh, pcfg, ocfg, timed=1)}
        assert [rec["probe"][k]["layers"] for k in ("L1", "L2")] == \
            ([2, 4] if cfg.family == "hybrid" else [1, 2])
        assert dryrun.corrected_totals(rec, cfg) == {
            "flops": full["cost"]["flops"], "bytes_accessed": full["cost"]["bytes accessed"],
            "collective_bytes": full["collective_bytes"]}, (arch, shape.kind)
        assert full["cost"]["flops"] > 0 and full["collective_bytes"] > 0
        assert all(v == 0 for v in full["launches"].values())    # the CPU: plain versions


class Recorded:
    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def jax_rank_bytes(shapes, specs, mesh_shape):
    """One rank's bytes of the JAX leaves ``shapes`` placed by ``specs``."""
    def one(t, spec):
        n = np.dtype(t.dtype).itemsize
        for i, size in enumerate(t.shape):
            names = spec[i] if i < len(spec) else None
            names = () if names is None else (names,) if isinstance(names, str) else names
            n *= -(-size // int(np.prod([mesh_shape[a] for a in names])))
        return n
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, Recorded))
    assert len(leaves) == len(spec_leaves)
    return sum(one(t, s.spec) for t, s in zip(leaves, spec_leaves))


PLACED = [("llama3.2-1b", "train_4k", "single"), ("arctic-480b", "train_4k", "single"),
          ("mamba2-1.3b", "prefill_32k", "single"), ("mixtral-8x7b", "decode_32k", "multi"),
          ("whisper-medium", "decode_32k", "single"), ("zamba2-2.7b", "long_500k", "multi")]


@pytest.mark.parametrize("arch,shape_name,kind", PLACED)
def test_argument_bytes_equal_the_jax_setups(arch, shape_name, kind, monkeypatch):
    monkeypatch.setattr(j_sharding, "NamedSharding", Recorded)
    monkeypatch.setattr(j_steps, "NamedSharding", Recorded)
    mesh = make_production_mesh(multi_pod=kind == "multi")
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    jshape = next(s for s in J_SHAPES if s.name == shape_name)
    pcfg, ocfg = cell_policy(cfg, shape, mesh)
    jpcfg, jocfg = j_policy.paper_defaults(jcfg, jshape)
    got = dryrun.memory_per_device(steps.make_setup(cfg, shape, mesh, pcfg, ocfg))

    # the JAX setup's own placement: parameters in its param dtype, its specs
    jr, params, axes, pshard = j_steps._param_setup(
        jcfg, jpcfg, types.SimpleNamespace(shape=dict(mesh.shape)))
    batch = j_steps.input_specs(jcfg, jshape, jpcfg)
    want = jax_rank_bytes(batch, j_steps.batch_shardings(jcfg, jshape, jr), mesh.shape)
    if jshape.kind == "train":
        opt = jax.eval_shape(lambda p: j_optim.init_adam(p, jocfg), params)
        want += jax_rank_bytes((params, opt),
                               (pshard, j_steps.opt_state_shardings(jr, axes, jocfg)),
                               mesh.shape)
    else:
        want += jax_rank_bytes(params, pshard, mesh.shape)
    if jshape.kind == "decode":
        import jax.numpy as jnp
        state = jax.eval_shape(lambda: jtfm.init_decode_state(
            jcfg, jshape.global_batch, jshape.seq_len, jnp.bfloat16))
        want += jax_rank_bytes(state, jr.decode_state_shardings(jcfg, jshape.global_batch),
                               mesh.shape)
    assert got["argument_bytes"] == want
    assert got["temp_bytes"] is None and got["total_bytes"] == \
        got["argument_bytes"] + got["output_bytes"] - got["alias_bytes"]


def test_card_shape_is_the_fewest_sequences_the_batch_axes_divide():
    cfg = registry.get_config("llama3.2-1b")
    for kind, B in (("single", 2), ("multi", 4)):
        mesh = dryrun.card_mesh(kind, "cpu")
        for shape in SHAPES:
            pcfg, _ = cell_policy(cfg, shape, mesh)
            got = dryrun.card_shape(cfg, shape, mesh, pcfg)
            assert got.global_batch == (1 if shape.global_batch == 1 else B), shape.name
            assert got.seq_len == shape.seq_len


def test_no_tp_runs_over_two_data_axes():
    """The perf plan's no-TP variants: data and model both data axes, the
    model axis the sync's inner one; the loss and gradient equal the
    one-device step's."""
    cfg = registry.get_config("chatglm3-6b").reduced()
    shape = ShapeConfig("t", "train", 32, 4)
    mesh = StackedMesh((2, 2), ("data", "model"), "cpu")
    pcfg = ParallelConfig(tp_axis="", seq_shard=False, remat="none", param_dtype="float32")
    setup = steps.make_train_setup(cfg, shape, mesh, pcfg)
    params = dryrun.tfm.init(0, cfg, dtype=torch.float32, device="cpu")
    batch = dryrun._batch(cfg, shape, pcfg, 3, torch.device("cpu"))
    synced, m = setup.grad_fn(setup.init_state(params), batch)
    want, wm = steps.train_grads(params, batch, cfg, pcfg)
    torch.testing.assert_close(m["loss"], wm["loss"], rtol=1e-5, atol=1e-6)
    for s, g, w in zip(tree_flatten(setup.param_shardings, is_leaf=lambda x: type(x) is tuple)[0],
                       tree_flatten(synced)[0], tree_flatten(want)[0]):
        torch.testing.assert_close(dryrun.steps.unshard_leaf(g, s, mesh), w,
                                   rtol=1e-4, atol=1e-6)


JAX_TOOLS = '''
import json
from repro.launch.dryrun import ep_compare, serving_compare
print(json.dumps({"ep": ep_compare(), "serving": serving_compare()}, default=str))
'''


@pytest.fixture(scope="module")
def jax_tools():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", JAX_TOOLS], capture_output=True, text=True,
                         timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_ep_compare_equals_jax(jax_tools):
    got, want = dryrun.ep_compare(device="cpu"), jax_tools["ep"]
    for key in ("n_devices", "capacity", "expected_bucket_bytes_per_device",
                "model_token_bytes_per_device", "measured_a2a_bytes_per_device",
                "measured_over_bucket", "bucket_over_token"):
        assert got[key] == want[key], key
    assert got["measured_over_bucket"] == 1


def test_serving_compare_has_the_jax_records_form(jax_tools):
    """The record has the JAX record's form, and its analytical column (the
    serving objective's quote for the full arch) equals the JAX one."""
    got, want = dryrun.serving_compare(device="cpu"), jax_tools["serving"]
    assert set(want) <= set(got) and set(want["measured"]) <= set(got["measured"])
    assert got["reduced"] == want["reduced"]
    assert got["measured"]["n_decode_steps"] == want["measured"]["n_decode_steps"]
    assert got["analytical"] == want["analytical"]
    assert "analytical_why" not in got
    assert got["measured"]["decode_step_p50_s"] > 0


class _ReachedSetup(Exception):
    def __init__(self, pcfg):
        super().__init__("make_setup reached")
        self.pcfg = pcfg


def test_run_cell_refuses_the_simulators_strategy(monkeypatch):
    """``run_cell(..., autostrategy=True, device="cpu")`` reaches
    ``steps.make_setup`` with the ``pcfg`` that the JAX ``cell_policy``
    stamps; a stand-in ``make_setup`` stops it there, so no step runs.  (The
    name is historical: the dry run refused the simulator's strategy until
    the port had the decision stack.)"""
    def stop(cfg, shape, mesh, pcfg, ocfg):
        raise _ReachedSetup(pcfg)

    monkeypatch.setattr(dryrun.steps, "make_setup", stop)
    with pytest.raises(_ReachedSetup) as got:
        dryrun.run_cell("llama3.2-1b", "train_4k", "single", autostrategy=True, device="cpu")
    want, _ = j_policy.cell_policy(j_registry.get_config("llama3.2-1b"), J_SHAPES[0], None,
                                   autostrategy=True)
    assert vars(got.value.pcfg.auto_strategy) == vars(want.auto_strategy)
    assert tuple(got.value.pcfg.auto_strategy) == (2, 64, 1, 2, "ring")
    assert got.value.pcfg.grad_sync == want.grad_sync == "hierarchical"


def test_run_cell_skips_what_jax_skips():
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", "single", device="cpu")
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


@pytest.mark.parametrize("module,args", [("dryrun", ["--arch", "llama3.2-1b"]),
                                         ("dryrun", ["--ep-compare"]), ("perf", [])])
def test_the_clis_refuse_to_run_without_a_gpu(module, args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    out = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}", *args,
                          "--out", str(tmp_path / "out")], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT), env={"PYTHONPATH": SRC, "PATH": ""})
    assert out.returncode != 0 and "GPU" in out.stderr
    assert not (tmp_path / "out").exists()
