"""The MoE family (mixtral-8x7b, arctic-480b) inside the setups of
``parallel.steps``: tensor parallelism over ``model`` (``models.moe.moe_ffn(
tp=)``) and expert parallelism over ``data`` (``moe_ep_axis``,
``models.moe.moe_ffn_lanes``), on the CPU, at reduced size (4 experts), fp32,
on the same converted weights (``convert.py``).

References:

(i)   The one-device ``make_train_step`` / ``prefill`` / ``decode_step``:
      the train setups over ``(data 2, model 2)`` and ``(data 4, model 2)``
      under replicated, zero1 and fsdp with block remat, a reduced mixtral
      whose 3 experts do not divide ``model`` 2 (their ``mlp`` dim split),
      and expert parallelism with ``moe_ep_axis="data"`` under replicated
      and fsdp over ``data 4`` alone and beside ``model`` 2 (and over ``pod
      2 x data 2 x model 2``, the expert leaves synced over ``pod`` only):
      the loss within 1e-5 relative, every synced gradient leaf and every
      updated parameter within 1e-5 absolute; a prefill and 4 decode steps
      through the serving setups within ``MODEL_TOL`` (atol 1e-4 / rtol
      1e-3).  The capacity factor is the configs' 1.25, so choices drop: the
      setups route one group a sequence, as the one-device path does.
(ii)  The aux loss and the router's gradient against the one-device ones,
      and the routing counted once a batch row under TP (``_route`` calls).
(iii) The all-reduces of a step and of a serving call through
      ``ops.reduce_shards`` against ``chip_smoke.py::tp_tree_launches``
      (extended for the MoE FFN: its input's and its combine weights' f);
      the flash calls at a rank's heads; a rank's bytes of the experts.
(iv)  The JAX ``make_train_setup`` / ``make_prefill_setup`` /
      ``make_decode_setup`` on 8 host devices, a (4, 2) ``data`` / ``model``
      mesh, in one module-scoped subprocess, against the port's own (4, 2)
      setups: one step's metrics and parameters, the logits of a prefill and
      4 decode steps; with ``moe_ep_axis="data"`` too.  There the capacity
      factor is E / k (nothing drops), as ``tests/test_torch_setup.py`` has
      it against JAX.  zero1 with ``moe_ep_axis`` raises
      ``DuplicateSpecError`` in JAX, a ``ValueError`` in the port.
(v)   One spawned world of 4 ``gloo`` ranks on ``(data 2, model 2)``: an
      fsdp TP step and an EP + TP step of mixtral, a prefill and 2 decode
      steps under EP + TP, each bit-equal to the ``StackedMesh``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.steps import (TrainState, _leaf_paths, make_setup,
                                        make_train_setup, make_train_step)
from repro_torch.train.optim import OptimConfig, init_adam

from tests.test_torch_setup import SRC, clone, flat, leaves, nest
from tests.test_torch_tp import (NEW, Counting, MODEL_TOL, OCFG, cache_len, jax_params,
                                 make_batch, one_device_grads, one_device_serve, params_of,
                                 serve_batch, specs_of, tp_reduce_launches, whole)

B, S = 8, 16
ARCHS = ("mixtral-8x7b", "arctic-480b")
# (mesh shape, axes)
MESHES = {"data2-model2": ((2, 2), ("data", "model")),
          "data4-model2": ((4, 2), ("data", "model")),
          "data4": ((4,), ("data",)),
          "pod2-data2-model2": ((2, 2, 2), ("pod", "data", "model"))}
SHARDINGS = ("replicated", "zero1", "fsdp")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (as the other
    setup test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch, no_drops=False, **kw):
    cfg = get_config(arch).reduced(**kw)
    if no_drops:          # every choice fits its expert's bucket (the JAX comparisons)
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def pcfg_of(sharding, ep=False, kind="train", sync="flat"):
    kw = dict(param_sharding=sharding, moe_ep_axis="data" if ep else "")
    if kind == "train":
        kw.update(grad_sync=sync, remat="block")
    return ParallelConfig(**kw)


def setup_of(cfg, mesh_name, sharding, ep=False, kind="train", ocfg=None, sync="flat"):
    mesh = make_mesh(*MESHES[mesh_name], device="cpu")
    pcfg = pcfg_of(sharding, ep, kind, sync)
    if kind == "train":
        return make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg,
                                ocfg or OptimConfig(**OCFG))
    return make_setup(cfg, ShapeConfig(kind, kind, cache_len(cfg), B), mesh, pcfg)


def one_device_step(cfg, p0, batch):
    ocfg = OptimConfig(**OCFG)
    pcfg = ParallelConfig(remat="none")
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    want_g = one_device_grads(ref.params, batch, cfg, pcfg)
    ref, m_ref = make_train_step(cfg, pcfg, ocfg)(ref, batch)
    return want_g, ref, m_ref


def check_train(cfg, p0, setup, batch):
    """One step of ``setup`` against the one-device step: the loss, the aux
    loss, the token count, the grad norm, every synced gradient leaf and
    every updated parameter."""
    want_g, ref, m_ref = one_device_step(cfg, p0, batch)
    state = setup.init_state(clone(p0))
    synced, m = setup.grad_fn(state, batch)
    for g, w in zip(whole(setup, synced), leaves(want_g)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    state, om = setup.update_fn(state, synced)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-5, err_msg=k)
    assert float(m["tokens"]) == float(m_ref["tokens"])
    np.testing.assert_allclose(float(om["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-5)
    for g, w in zip(whole(setup, state.params), leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    return synced, want_g


def setup_serve(cfg, params, batch, steps, mesh_name, sharding, ep=False):
    pre = setup_of(cfg, mesh_name, sharding, ep, kind="prefill")
    dec = setup_of(cfg, mesh_name, sharding, ep, kind="decode")
    placed = pre.init_state(params)
    logits, state = pre.step_fn(placed, batch)
    out = [logits]
    for tok in steps:
        logits, state = dec.step_fn(placed, state, tok)
        out.append(logits)
    return out, state


def check_serve(cfg, p0, mesh_name, sharding, ep=False):
    batch, steps = serve_batch(cfg)
    want, _ = one_device_serve(cfg, p0, batch, steps)
    got, _ = setup_serve(cfg, clone(p0), batch, steps, mesh_name, sharding, ep)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"step {i}", **MODEL_TOL)


# --------------------------------------------------------------------------
# (i) against the one-device path
# --------------------------------------------------------------------------

TP_CASES = [(a, m, s) for a in ARCHS for m in ("data2-model2", "data4-model2")
            for s in SHARDINGS]


@pytest.mark.parametrize("arch,mesh_name,sharding", TP_CASES)
def test_moe_tp_train_setup_equals_the_one_device_step(arch, mesh_name, sharding):
    """4 experts over model 2: a rank holds 2 experts; arctic's dense
    residual is split column / row."""
    cfg = config(arch)
    setup = setup_of(cfg, mesh_name, sharding)
    assert setup.ruleset.expert_sharded and setup.ruleset.tp == "model"
    check_train(cfg, params_of(arch), setup, make_batch(cfg, 1))


@pytest.mark.parametrize("arch,mesh_name,sharding", TP_CASES)
def test_moe_tp_serving_setups_equal_the_one_device_path(arch, mesh_name, sharding):
    check_serve(config(arch), params_of(arch), mesh_name, sharding)


@pytest.mark.parametrize("sharding", SHARDINGS)
def test_experts_that_do_not_divide_split_their_hidden_dim(sharding):
    """3 experts over model 2: each rank holds every expert's columns of
    ``w_gate`` / ``w_up`` and rows of ``w_down`` (under fsdp over ``('model',
    'data')`` jointly), trained and served against the one-device path."""
    cfg = config("mixtral-8x7b", n_experts=3)
    p0 = params_of("mixtral-8x7b", n_experts=3)
    setup = setup_of(cfg, "data2-model2", sharding)
    assert not setup.ruleset.expert_sharded
    want = {"replicated": (None, None, "model"), "zero1": (None, None, "model"),
            "fsdp": (None, None, ("model", "data"))}[sharding]
    assert setup.param_shardings["blocks"][0]["ffn"]["w_gate"] == want
    check_train(cfg, p0, setup, make_batch(cfg, 2))
    check_serve(cfg, p0, "data2-model2", sharding)


EP_CASES = [(a, m, s) for a in ARCHS for m in ("data4", "data2-model2", "data4-model2")
            for s in ("replicated", "fsdp")]


@pytest.mark.parametrize("arch,mesh_name,sharding", EP_CASES)
def test_ep_train_setup_equals_the_one_device_step(arch, mesh_name, sharding):
    """The experts over data (each rank E / n of them; beside model 2 their
    ``mlp`` dim over model), the lanes of the data axis through every MoE
    block together; the expert leaves' gradient is the lanes' sum, divided
    by them."""
    cfg = config(arch)
    setup = setup_of(cfg, mesh_name, sharding, ep=True)
    assert setup.ruleset.ep_axis == "data"
    tp = "model" if "model" in MESHES[mesh_name][1] else None
    assert setup.param_shardings["blocks"][0]["ffn"]["w_gate"] == ("data", None, tp)
    check_train(cfg, params_of(arch), setup, make_batch(cfg, 3))


@pytest.mark.parametrize("arch,mesh_name,sharding", EP_CASES)
def test_ep_serving_setups_equal_the_one_device_path(arch, mesh_name, sharding):
    check_serve(config(arch), params_of(arch), mesh_name, sharding, ep=True)


@pytest.mark.parametrize("sync", ["flat", "hierarchical"])
def test_ep_beside_a_pod_axis_syncs_the_experts_over_pod(sync):
    """pod 2 x data 2 x model 2, fsdp: two EP groups (one a pod); an expert
    leaf's gradient is reduced over pod alone."""
    cfg = config("mixtral-8x7b")
    setup = setup_of(cfg, "pod2-data2-model2", "fsdp", ep=True, sync=sync)
    check_train(cfg, params_of("mixtral-8x7b"), setup, make_batch(cfg, 4))


# --------------------------------------------------------------------------
# (ii) routing once, the aux loss and the router
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name,ep", [("data2-model2", False), ("data4-model2", True)])
def test_routing_runs_once_a_row_and_its_gradient_is_the_one_device_one(monkeypatch,
                                                                       mesh_name, ep):
    """Under TP the router runs once on a batch row's whole input (not once a
    TP rank), under EP once a lane; the aux loss and the router's synced
    gradient equal the one-device ones."""
    cfg = config("arctic-480b")
    p0 = params_of("arctic-480b")
    batch = make_batch(cfg, 5)
    setup = setup_of(cfg, mesh_name, "fsdp", ep)
    calls = []
    plain = moe._route

    def route(x, *a):
        calls.append(tuple(x.shape))
        return plain(x, *a)
    monkeypatch.setattr(moe, "_route", route)
    synced, want_g = check_train(cfg, p0, setup, batch)
    rows = setup.mesh.size(("data",))
    # forward and block remat's recompute, every layer, every row
    assert calls.count((B // rows, S, cfg.d_model)) == 2 * cfg.num_layers * rows
    paths = list(_leaf_paths(setup.param_shapes))
    got, want = whole(setup, synced), leaves(want_g)
    for l in range(cfg.num_layers):
        i = paths.index(f"blocks/{l}/ffn/router")
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# (iii) the collectives, the heads, the bytes
# --------------------------------------------------------------------------

def _model_axes(spec):
    return [a for e in spec if e for a in ((e,) if isinstance(e, str) else e)]


def sync_launches(setup, sharding):
    """Tree reduces of the data sync (flat: one a synced block): every leaf
    the ranks share once, under fsdp once each model block; an expert leaf
    held over the EP axis none (no outer axis here)."""
    axes = tree_flatten(tfm.param_axes(setup.cfg, stacked=False),
                        is_leaf=lambda x: isinstance(x, tuple))[0]
    ep = setup.ruleset.ep_axis
    n = 0
    for a, s in zip(axes, specs_of(setup)):
        if ep and "expert" in a:
            continue
        n += 2 if sharding == "fsdp" and "model" in _model_axes(s) else 1
    return n


@pytest.mark.parametrize("arch,sharding,ep", [("mixtral-8x7b", "fsdp", False),
                                              ("arctic-480b", "zero1", False),
                                              ("mixtral-8x7b", "replicated", True),
                                              ("arctic-480b", "fsdp", True)])
def test_every_moe_all_reduce_goes_through_the_tree_reduce(monkeypatch, arch, sharding, ep):
    """A step over (data 2, model 2): each batch row's TP group (under EP each
    lane) runs ``tp_tree_launches``'s all-reduces, then the sync; every flash
    call sees a rank's heads."""
    cfg = config(arch)
    setup = setup_of(cfg, "data2-model2", sharding, ep)
    state = setup.init_state(params_of(arch))
    count = Counting(monkeypatch)
    setup.grad_fn(state, make_batch(cfg, 6))
    assert count.reduce == 2 * tp_reduce_launches(cfg, "train") + sync_launches(setup, sharding)
    assert count.heads == {(cfg.n_heads // 2, cfg.n_kv_heads // 2)}
    assert count.attn == 2 * 2 * 2 * cfg.num_layers   # rows x ranks x (forward, recompute)


@pytest.mark.parametrize("arch,ep", [("mixtral-8x7b", True), ("arctic-480b", False)])
def test_a_moe_serving_call_runs_its_all_reduces(monkeypatch, arch, ep):
    cfg = config(arch)
    batch, steps = serve_batch(cfg)
    pre = setup_of(cfg, "data2-model2", "fsdp", ep, kind="prefill")
    dec = setup_of(cfg, "data2-model2", "fsdp", ep, kind="decode")
    placed = pre.init_state(params_of(arch))
    count = Counting(monkeypatch)
    _, state = pre.step_fn(placed, batch)
    assert count.reduce == 2 * tp_reduce_launches(cfg, "prefill")
    count.reduce = 0
    dec.step_fn(placed, state, steps[0])
    assert count.reduce == 2 * tp_reduce_launches(cfg, "decode")
    assert count.heads == {(cfg.n_heads // 2, cfg.n_kv_heads // 2)}


@pytest.mark.parametrize("mesh_name,ep,share", [("data2-model2", False, 2),
                                                ("data4-model2", True, 8),
                                                ("data4", True, 4)])
def test_a_rank_holds_its_experts(mesh_name, ep, share):
    """A rank's block of each expert leaf: E / 2 experts over model 2; under
    EP E / n experts, beside model 2 half their ``mlp`` dim too."""
    cfg = config("mixtral-8x7b")
    setup = setup_of(cfg, mesh_name, "replicated", ep)
    state = setup.init_state(params_of("mixtral-8x7b"))
    ffn = state.params["blocks"][0]["ffn"]
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for name in moe.EXPERT_LEAVES:
        assert ffn[name][0].numel() == E * d * f // share, name
        assert ffn[name].shape[0] == share


# --------------------------------------------------------------------------
# (iv) against the JAX setups on 8 host devices
# --------------------------------------------------------------------------

# a case name: the sharding, "-ep" with moe_ep_axis="data"
JAX_TRAIN = ("replicated", "zero1", "fsdp", "replicated-ep", "fsdp-ep")
JAX_SERVE = ("fsdp", "fsdp-ep")

JAX_RUN = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as tfm
from repro.models.config import ParallelConfig, ShapeConfig
from repro.models.modules import split
from repro.parallel.steps import (TrainState, make_decode_setup, make_prefill_setup,
                                  make_train_setup)
from repro.train.optim import OptimConfig, init_adam
ARCHS, TRAIN, SERVE, OCFG, NEW = {archs!r}, {train!r}, {serve!r}, {ocfg!r}, {new}
inp = dict(np.load(sys.argv[1]))
out = {{}}


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out[prefix + k] = np.asarray(v, np.float32)


mesh = make_mesh((4, 2), ("data", "model"))
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    batch = {{k: jnp.asarray(inp[arch + "|train|" + k]) for k in ("tokens", "labels")}}
    B, S = batch["tokens"].shape
    params = split(tfm.init(jax.random.PRNGKey(0), cfg))[0]
    for name in TRAIN + ("zero1-ep",):
        sharding, ep = name.split("-")[0], name.endswith("-ep")
        pcfg = ParallelConfig(param_sharding=sharding, remat="none", param_dtype="float32",
                              compute_dtype="float32", moe_ep_axis="data" if ep else "")
        ocfg = OptimConfig(**OCFG)
        try:
            setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, ocfg)
        except Exception as e:
            out[arch + "|" + name + "|raised"] = np.array(type(e).__name__)
            continue
        with mesh:
            state = jax.jit(lambda p: TrainState(p, init_adam(p, ocfg)),
                            out_shardings=setup.state_shardings)(params)
            state, m = setup.step_fn(state, batch)
        for k in ("loss", "aux_loss", "tokens", "grad_norm"):
            out[arch + "|" + name + "|" + k] = np.asarray(m[k], np.float32)
        flat(state.params, arch + "|" + name + "|p1|")
    sb = {{"tokens": jnp.asarray(inp[arch + "|serve|tokens"])}}
    cache = int(inp[arch + "|cache"])
    for name in SERVE:
        ep = name.endswith("-ep")
        pcfg = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                              moe_ep_axis="data" if ep else "")
        pre = make_prefill_setup(cfg, ShapeConfig("p", "prefill", cache, B), mesh, pcfg)
        dec = make_decode_setup(cfg, ShapeConfig("d", "decode", cache, B), mesh, pcfg)
        with mesh:
            p = jax.jit(lambda x: x, out_shardings=pre.param_shardings)(params)
            logits, state = pre.step_fn(p, sb)
            out[f"{{arch}}|{{name}}|serve|0"] = np.asarray(logits, np.float32)
            for i in range(NEW):
                logits, state = dec.step_fn(p, state, jnp.asarray(inp[f"{{arch}}|step{{i}}"]))
                out[f"{{arch}}|{{name}}|serve|{{i + 1}}"] = np.asarray(logits, np.float32)
np.savez(sys.argv[2], **out)
print("JAX_MOE_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_moe")
    inp = {}
    for arch in ARCHS:
        cfg = config(arch, no_drops=True)
        for k, v in make_batch(cfg, 7).items():
            inp[f"{arch}|train|{k}"] = v
        batch, steps = serve_batch(cfg)
        inp[f"{arch}|serve|tokens"] = batch["tokens"]
        for i, tok in enumerate(steps):
            inp[f"{arch}|step{i}"] = tok
        inp[f"{arch}|cache"] = np.array(cache_len(cfg))
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN.format(archs=ARCHS, train=JAX_TRAIN, serve=JAX_SERVE,
                                              ocfg=OCFG, new=NEW),
         str(d / "inputs.npz"), str(d / "jax.npz")],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, f"JAX subprocess failed:\n{proc.stderr[-3000:]}"
    return inp, dict(np.load(d / "jax.npz"))


def _jax_params(arch):
    return from_jax_params(jax_params(arch), config(arch), device="cpu")


@pytest.mark.parametrize("arch,name", [(a, n) for a in ARCHS for n in JAX_TRAIN])
def test_moe_train_setup_equals_the_jax_setup_on_8_host_devices(jax_moe, arch, name):
    """One step of the port's (4, 2) setup against the JAX one on the same
    mesh: the metrics and every parameter after it, gathered whole."""
    inp, out = jax_moe
    cfg = config(arch, no_drops=True)
    sharding, ep = name.split("-")[0], name.endswith("-ep")
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh,
                             ParallelConfig(param_sharding=sharding, remat="none",
                                            moe_ep_axis="data" if ep else ""),
                             OptimConfig(**OCFG))
    state, m = setup.step_fn(setup.init_state(_jax_params(arch)),
                             {k: inp[f"{arch}|train|{k}"] for k in ("tokens", "labels")})
    pre = f"{arch}|{name}|"
    for k in ("loss", "aux_loss", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(out[pre + k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = from_jax_params(nest({k[len(pre) + 3:]: v for k, v in out.items()
                                 if k.startswith(pre + "p1|")}), cfg, device="cpu")
    for g, w in zip(whole(setup, state.params), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,name", [(a, n) for a in ARCHS for n in JAX_SERVE])
def test_moe_serving_setups_equal_the_jax_setups_on_8_host_devices(jax_moe, arch, name):
    _, out = jax_moe
    cfg = config(arch, no_drops=True)
    batch, steps = serve_batch(cfg)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    pcfg = ParallelConfig(moe_ep_axis="data" if name.endswith("-ep") else "")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", cache_len(cfg), B), mesh, pcfg)
    dec = make_setup(cfg, ShapeConfig("d", "decode", cache_len(cfg), B), mesh, pcfg)
    placed = pre.init_state(_jax_params(arch))
    logits, state = pre.step_fn(placed, {"tokens": batch["tokens"]})
    got = [logits]
    for tok in steps:
        logits, state = dec.step_fn(placed, state, tok)
        got.append(logits)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), out[f"{arch}|{name}|serve|{i}"],
                                   err_msg=f"step {i}", **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_with_ep_is_refused_where_jax_raises(jax_moe, arch):
    """JAX's zero1 setup with ``moe_ep_axis="data"`` raises
    ``DuplicateSpecError``: ``opt_spec`` puts ``data`` on the experts'
    ``embed`` dim beside their ``expert`` dim.  The port refuses the same
    cell with a ``ValueError`` naming the duplicated axis."""
    _, out = jax_moe
    assert str(out[f"{arch}|zero1-ep|raised"]) == "DuplicateSpecError"
    with pytest.raises(ValueError, match="zero1 with moe_ep_axis='data'.*'data'.*duplicated"):
        setup_of(config(arch), "data4-model2", "zero1", ep=True)


# --------------------------------------------------------------------------
# (v) the distributed transport
# --------------------------------------------------------------------------

GLOO_TRAIN = [("fsdp", False), ("replicated", True), ("fsdp", True)]

GLOO_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.sharding import unshard_leaf
from repro_torch.parallel.steps import make_setup, make_train_setup
from repro_torch.train.optim import OptimConfig
TRAIN, OCFG, B, S, NEW = {train!r}, {ocfg!r}, {B}, {S}, {new}
rank, store, inputs, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
inp = dict(np.load(inputs))
out = {{}}
IS_SPEC = dict(is_leaf=lambda x: isinstance(x, tuple))


def nest(items):
    tree = {{}}
    for path, v in items.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {{}})
        node[last] = v
    return tree


def whole(tree, setup):
    specs = tree_flatten(setup.param_shardings, **IS_SPEC)[0]
    return [unshard_leaf(t, s, setup.mesh) for t, s in zip(tree_flatten(tree)[0], specs)]


cfg = get_config("mixtral-8x7b").reduced()
params = lambda: from_jax_params(nest({{k[2:]: v for k, v in inp.items() if k.startswith("p|")}}),
                                 cfg, device="cpu")
batch = {{k: inp["train|" + k] for k in ("tokens", "labels")}}
mesh = make_dist_mesh((2, 2), ("data", "model"), device="cpu")
for n, (sharding, ep) in enumerate(TRAIN):
    pcfg = ParallelConfig(param_sharding=sharding, grad_sync="flat", remat="block",
                          moe_ep_axis="data" if ep else "")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg,
                             OptimConfig(**OCFG))
    state = setup.init_state(params())
    synced, m = setup.grad_fn(state, batch)
    for i, g in enumerate(whole(synced, setup)):
        out[f"{{n}}|g|{{i}}"] = g.numpy()
    state, om = setup.update_fn(state, synced)
    for k, v in {{**m, **om}}.items():
        out[f"{{n}}|m|{{k}}"] = v.float().numpy()
    for i, p in enumerate(whole(state.params, setup)):
        out[f"{{n}}|p|{{i}}"] = p.numpy()
pcfg = ParallelConfig(moe_ep_axis="data")
pre = make_setup(cfg, ShapeConfig("p", "prefill", S + NEW, B), mesh, pcfg)
dec = make_setup(cfg, ShapeConfig("d", "decode", S + NEW, B), mesh, pcfg)
p = pre.init_state(params())
logits, state = pre.step_fn(p, {{"tokens": inp["serve|tokens"]}})
out["serve|0"] = logits.numpy()
for t in range(2):
    logits, state = dec.step_fn(p, state, inp[f"serve|step{{t}}"])
    out[f"serve|{{t + 1}}"] = logits.numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_moe")
    cfg = config("mixtral-8x7b")
    inp = {"p|" + k: v for k, v in flat(jax_params("mixtral-8x7b")).items()}
    for k, v in make_batch(cfg, 8).items():
        inp["train|" + k] = v
    batch, steps = serve_batch(cfg)
    inp["serve|tokens"] = batch["tokens"]
    for t, tok in enumerate(steps):
        inp[f"serve|step{t}"] = tok
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    worker = GLOO_WORKER.format(train=GLOO_TRAIN, ocfg=OCFG, B=B, S=S, new=NEW)
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(rank), str(d / "gloo_store"),
         str(d / "inputs.npz"), str(d / f"rank_{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(4)]
    try:
        logs = [p.communicate(timeout=300) for p in procs]   # one limit for the world
    finally:
        for p in procs:
            p.kill()
    bad = [(i, err[-2000:]) for i, (p, (_, err)) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"gloo ranks failed: {bad}"
    return inp, [dict(np.load(d / f"rank_{rank}.npz")) for rank in range(4)]


@pytest.mark.parametrize("n", range(len(GLOO_TRAIN)),
                         ids=[s + ("-ep" if ep else "") for s, ep in GLOO_TRAIN])
def test_gloo_moe_train_step_equals_the_stacked_mesh(gloo_world, n):
    """One step of mixtral over (data 2, model 2) on 4 ``gloo`` ranks: the
    synced gradient, the metrics and the updated parameters (gathered whole)
    equal the ``StackedMesh``'s bit for bit on every rank."""
    inp, ranks = gloo_world
    sharding, ep = GLOO_TRAIN[n]
    cfg = config("mixtral-8x7b")
    setup = setup_of(cfg, "data2-model2", sharding, ep)
    state = setup.init_state(params_of("mixtral-8x7b"))
    synced, m = setup.grad_fn(state, {k: inp["train|" + k] for k in ("tokens", "labels")})
    grads = whole(setup, synced)
    state, om = setup.update_fn(state, synced)
    for rank, res in enumerate(ranks):
        for i, g in enumerate(grads):
            assert np.array_equal(res[f"{n}|g|{i}"], g.numpy()), (rank, i)
        for k, v in {**m, **om}.items():
            assert np.array_equal(res[f"{n}|m|{k}"], v.float().numpy()), (rank, k)
        for i, p in enumerate(whole(setup, state.params)):
            assert np.array_equal(res[f"{n}|p|{i}"], p.numpy()), (rank, i)


def test_gloo_moe_ep_serving_equals_the_stacked_mesh(gloo_world):
    """A prefill and two decode steps of mixtral under EP + TP (fsdp) on 4
    ``gloo`` ranks: each rank its lane, its KV heads, its experts' ``mlp``
    block; the gathered logits equal the stacked mesh's bit for bit."""
    inp, ranks = gloo_world
    cfg = config("mixtral-8x7b")
    batch, steps = serve_batch(cfg)
    got, _ = setup_serve(cfg, params_of("mixtral-8x7b"), batch, steps[:2], "data2-model2",
                         "fsdp", ep=True)
    for rank, res in enumerate(ranks):
        for t, w in enumerate(got):
            assert np.array_equal(res[f"serve|{t}"], w.numpy()), (rank, t)
