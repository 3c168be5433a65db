"""The data-parallel train setup (``parallel.steps.make_train_setup``,
``param_sharding`` replicated and zero1; FSDP has its own file,
``tests/test_torch_fsdp.py``) on the CPU, at reduced size.

References:

(i)   the port's one-device ``make_train_step`` on the whole batch: reduced
      llama3.2-1b in fp32 and bf16 and reduced mixtral-8x7b in fp32 (its
      capacity factor E / k, so that no choice drops), over a ``StackedMesh``
      of data 4 (zero1, flat sync), pod 2 x data 2 (replicated, hierarchical)
      and pod 2 x data 2 x model 1 (zero1, hierarchical): loss, every synced
      gradient leaf, ``grad_norm``, the parameters after one and two steps;
      and the AdamW update of zero1 bit-equal to the replicated one on the
      same synced gradient.  The labels carry -1 unevenly over the shards
      (one shard wholly masked in a second batch).
(ii)  the JAX ``make_train_setup`` on 8 host devices, a (4, 2) ``data`` /
      ``model`` mesh, in one module-scoped subprocess (as
      ``tests/test_multidevice.py`` builds it): one step from the converted
      weights, loss, ``grad_norm`` and every parameter after it, fp32; with
      fsdp (which JAX partitions there as FSDP plus TP, the port over data
      4) and with int8 moments under zero1 and fsdp too; and llama3.2-1b's
      five against the port's own (4, 2) setups, tensor parallelism over
      ``model`` 2 (``tests/test_torch_tp.py`` holds them against the
      one-device step).
(iii) one spawned world of 4 ``gloo`` ranks (a ``file://`` store, one timeout
      for the world): the ``DistMesh`` gives the ``StackedMesh``'s results,
      and under zero1 a rank holds a quarter of the optimizer state.

And one test for each refusal: compressed sync; a ``model`` axis of more
than one rank (the dense, moe and ssm families, once refused, now build),
fsdp (the ``ParallelConfig`` default) and int8 moments under zero1, once
refused, now run (their tests keep their names).

Tolerances, fp32: loss and ``grad_norm`` rtol 1e-5 (the rank's mean weighed
by its token share, then summed, against one mean over the batch; measured
~1e-7); gradients relative Frobenius 1e-5 per leaf (measured 4e-7);
parameters after a step atol 1e-5 (lr 3e-4 from step 1, Adam eps 1e-6: a
flipped update would show as 6e-4).  bf16: gradients relative Frobenius 2e-2
(``chip_smoke.py``'s ``tol(bf16)``; two bf16 roundings, the rank's gradient
and the synced mean, measured 4e-3), parameters rtol 2e-2 + 2 x lr, the loss
rtol 2e-3 (``chip_smoke.py``'s limit: after a step the parameters differ by
bf16 ulps, measured 1.2e-5).  The
``DistMesh`` against the ``StackedMesh``: bit for bit (the same shards go
through the same operations).
"""

import dataclasses
import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten, tree_map, tree_unflatten
from repro_torch.parallel.sharding import unshard_leaf
from repro_torch.parallel.steps import (TrainState, make_train_setup, make_train_step,
                                        train_grads)
from repro_torch.train.optim import OptimConfig, init_adam

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
B, S = 8, 32
OCFG = dict(warmup_steps=0, eps=1e-6)
# (mesh shape, axes, param_sharding, grad_sync)
CASES = {"zero1-data4-flat": ((4,), ("data",), "zero1", "flat"),
         "replicated-pod2-data2-hier": ((2, 2), ("pod", "data"), "replicated", "hierarchical"),
         "zero1-pod2-data2-model1-hier": ((2, 2, 1), ("pod", "data", "model"), "zero1",
                                          "hierarchical")}
# placements of the JAX comparison that the one-device test does not take
JAX_ONLY_CASES = {"fsdp-data4-flat": ((4,), ("data",), "fsdp", "flat")}
GLOO_CASES = [("llama3.2-1b", "float32", "zero1-data4-flat"),
              ("llama3.2-1b", "float32", "replicated-pod2-data2-hier"),
              ("mixtral-8x7b", "float32", "zero1-pod2-data2-model1-hier"),
              ("llama3.2-1b", "bfloat16", "zero1-data4-flat")]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: beside the other
    test workers on the same cores, a pool of threads per op spends its time
    waiting (the results do not depend on it; the gloo ranks run one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:     # every choice fits its expert's bucket: nothing drops
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def make_batch(cfg, seed, masked_shard=False, batch=B):
    """Tokens and labels (batch, S); row r's labels masked with probability
    r / 9, so that the four shards of two rows count unequal tokens; with
    ``masked_shard`` the last shard's labels are all -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[rng.random((batch, S)) < np.arange(batch)[:, None] / 9] = -1
    if masked_shard:
        labels[-2:] = -1
    return {"tokens": toks[:, :-1].copy(), "labels": labels}


def flat(tree, prefix=""):
    """{path: numpy} of a JAX-style tree of dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def nest(flat_items):
    tree = {}
    for path, v in flat_items.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def jax_params(arch):
    """The JAX package's reduced parameters (seed 0) as a numpy tree."""
    import jax
    from repro.configs.registry import get_config as j_get_config
    from repro.models import transformer as jtfm
    from repro.models.modules import split
    jcfg = j_get_config(arch).reduced()
    vals = split(jtfm.init(jax.random.PRNGKey(0), jcfg))[0]
    return jax.tree.map(np.asarray, vals)


_PARAMS = {}


def params_of(arch, dtype):
    if arch not in _PARAMS:
        _PARAMS[arch] = jax_params(arch)
    return from_jax_params(_PARAMS[arch], config(arch), device="cpu", dtype=DTYPES[dtype])


def clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def leaves(tree):
    return tree_flatten(tree)[0]


def setup_of(cfg, case, ocfg=None, batch=B):
    shape, axes, sharding, sync = {**CASES, **JAX_ONLY_CASES}[case]
    mesh = make_mesh(shape, axes, device="cpu")
    pcfg = ParallelConfig(param_sharding=sharding, grad_sync=sync, remat="none")
    return make_train_setup(cfg, ShapeConfig("t", "train", S, batch), mesh, pcfg,
                            ocfg or OptimConfig(**OCFG))


def fro(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def run_setup(setup, params, batches):
    """Steps of the setup from ``params``: the first through ``grad_fn`` and
    ``update_fn`` (its synced gradient kept), the rest through ``step_fn``.
    Returns (state, [metrics], synced gradient of step 1)."""
    state = setup.init_state(params)
    synced, m = setup.grad_fn(state, batches[0])
    grads1 = clone(synced)
    state, om = setup.update_fn(state, synced)
    metrics = [{**m, **om}]
    for batch in batches[1:]:
        state, m = setup.step_fn(state, batch)
        metrics.append(m)
    return state, metrics, grads1


# --------------------------------------------------------------------------
# (i) against the one-device step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch,dtype", [("llama3.2-1b", "float32"), ("llama3.2-1b", "bfloat16"),
                                        ("mixtral-8x7b", "float32")])
def test_setup_equals_the_one_device_step(arch, dtype, case):
    cfg = config(arch)
    ocfg = OptimConfig(**OCFG)
    pcfg = ParallelConfig(remat="none")
    p0 = params_of(arch, dtype)
    batches = [make_batch(cfg, 1), make_batch(cfg, 2, masked_shard=True)]
    # the oracle: the whole batch on one device, in place on its own copy
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    want_g = [train_grads(ref.params, batches[0], cfg, pcfg)[0]]
    step = make_train_step(cfg, pcfg, ocfg)
    ref, m_ref = step(ref, batches[0])
    ref_p1 = clone(ref.params)
    want_g.append(train_grads(ref.params, batches[1], cfg, pcfg)[0])
    ref, m_ref2 = step(ref, batches[1])

    setup = setup_of(cfg, case)
    state = setup.init_state(clone(p0))
    got_p1 = None
    for i, batch in enumerate(batches):
        synced, m = setup.grad_fn(state, batch)
        state, om = setup.update_fn(state, synced)
        want_m = (m_ref, m_ref2)[i]
        for k in ("loss", "aux_loss", "tokens"):
            np.testing.assert_allclose(float(m[k]), float(want_m[k]), atol=1e-7,
                                       rtol=1e-5 if dtype == "float32" else 2e-3,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(om["grad_norm"]), float(want_m["grad_norm"]),
                                   rtol=1e-5 if dtype == "float32" else 2e-2)
        assert float(om["lr"]) == float(want_m["lr"])
        limit = 1e-5 if dtype == "float32" else 2e-2
        for g, w in zip(leaves(synced), leaves(want_g[i])):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert fro(g, w) <= limit, (i, tuple(g.shape), fro(g, w))
        if i == 0:
            got_p1 = clone(state.params)
    lr = float(m_ref["lr"])
    for got, want in ((got_p1, ref_p1), (state.params, ref.params)):
        for g, w in zip(leaves(got), leaves(want)):
            if dtype == "float32":
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
            else:
                np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                           rtol=2e-2, atol=2 * lr)


@pytest.mark.parametrize("case", ["replicated-pod2-data2-hier", "zero1-pod2-data2-model1-hier"])
def test_a_batch_that_leaves_a_data_axis_whole(case):
    """B 6 over pod 2 x data 2: the batch shards over pod alone (3 rows a
    shard; 6 does not split over data after that), so the two ranks of a data
    pair take the same rows; the synced mean is the one-device gradient."""
    cfg = config("llama3.2-1b")
    ocfg, pcfg = OptimConfig(**OCFG), ParallelConfig(remat="none")
    batch = make_batch(cfg, 9, batch=6)
    p0 = params_of("llama3.2-1b", "float32")
    setup = setup_of(cfg, case, batch=6)
    assert setup.ruleset.batch_axes(6) == ("pod",)
    want_g, _ = train_grads(p0, batch, cfg, pcfg)
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    ref, m_ref = make_train_step(cfg, pcfg, ocfg)(ref, batch)
    state = setup.init_state(clone(p0))
    synced, m = setup.grad_fn(state, batch)
    for g, w in zip(leaves(synced), leaves(want_g)):
        assert fro(g, w) <= 1e-5
    state, om = setup.update_fn(state, synced)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(om["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-5)
    for g, w in zip(leaves(state.params), leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero1_update_is_bit_equal_to_the_replicated_one(dtype):
    """On the same synced gradient, each rank's AdamW on its shard (the clip
    factor from the norm of the whole gradient) gives the replicated update
    bit for bit: parameters, master and moments."""
    cfg = config("llama3.2-1b")
    p0 = params_of("llama3.2-1b", dtype)
    batch = make_batch(cfg, 3)
    z = setup_of(cfg, "zero1-data4-flat")
    r = setup_of(cfg, "replicated-pod2-data2-hier")
    zs, rs = z.init_state(clone(p0)), r.init_state(clone(p0))
    grads, _ = z.grad_fn(zs, batch)
    zs, zm = z.update_fn(zs, grads)
    rs, rm = r.update_fn(rs, grads)
    assert torch.equal(zm["grad_norm"], rm["grad_norm"]) and torch.equal(zm["lr"], rm["lr"])
    for a, b in zip(leaves(zs.params), leaves(rs.params)):
        assert torch.equal(a, b)
    opt_specs = tree_flatten(z.state_shardings.opt.master,
                             is_leaf=lambda x: isinstance(x, tuple))[0]
    for field in ("master", "m", "v"):
        for rows, full, spec in zip(leaves(getattr(zs.opt, field)),
                                    leaves(getattr(rs.opt, field)), opt_specs):
            assert torch.equal(unshard_leaf(rows, spec, z.mesh), full), field


def test_a_step_leaves_no_tensor_in_a_reference_cycle():
    """Once a step's state and metrics are dropped, nothing of it waits for
    the garbage collector: no tensor sits in a reference cycle (a walk of a
    tree written as a closure that calls itself kept every leaf of the tree,
    the parameters and gradients of a step, until a collection)."""
    cfg = config("llama3.2-1b")
    batch = make_batch(cfg, 7)
    p0 = params_of("llama3.2-1b", "float32")
    gc.collect()

    def held():
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            gc.collect()
            return [o for o in gc.garbage if torch.is_tensor(o)]
        finally:
            gc.set_debug(0)
            gc.garbage.clear()

    pcfg, ocfg = ParallelConfig(remat="block"), OptimConfig(**OCFG)
    state = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    state, m = make_train_step(cfg, pcfg, ocfg)(state, batch)
    del state, m
    assert not held(), "the one-device step"
    for case in ("zero1-data4-flat", "replicated-pod2-data2-hier"):
        setup = setup_of(cfg, case)
        state, m = setup.step_fn(setup.init_state(clone(p0)), batch)
        del state, m, setup
        assert not held(), case


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def refused(pcfg=None, mesh=((4,), ("data",)), ocfg=None):
    cfg = config("llama3.2-1b")
    make_train_setup(cfg, ShapeConfig("t", "train", S, B), make_mesh(*mesh, device="cpu"),
                     pcfg, ocfg)


def test_fsdp_the_default_is_refused():
    """The name is historical: FSDP, the ``ParallelConfig`` default, was
    refused until it ran; now the default builds an fsdp setup that takes a
    step (``tests/test_torch_fsdp.py`` holds its results)."""
    cfg = config("llama3.2-1b")
    for pcfg in (None, ParallelConfig(param_sharding="fsdp")):
        setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B),
                                 make_mesh((4,), ("data",), device="cpu"), pcfg,
                                 OptimConfig(**OCFG))
        assert setup.pcfg.param_sharding == "fsdp"
        state, m = setup.step_fn(setup.init_state(params_of("llama3.2-1b", "float32")),
                                 make_batch(cfg, 1))
        assert np.isfinite(float(m["loss"])) and int(state.opt.step) == 1


def test_a_model_axis_of_more_than_one_rank_is_refused():
    """The name is historical: a ``model`` axis of more than one rank was
    refused until tensor parallelism ran; now a dense (4, 2) setup builds
    (``tests/test_torch_tp.py`` and ``test_tp_setup_equals_the_jax_setup``
    hold its results), and so do a mixtral one and a mamba2 one, whose lines
    were refused until the MoE family's TP and then the SSM family's ran
    (``tests/test_torch_moe_tp.py`` and ``tests/test_torch_ssm_tp.py`` hold
    their results)."""
    mesh = ((4, 2), ("data", "model"))
    refused(ParallelConfig(param_sharding="replicated"), mesh)
    setup = make_train_setup(config("mixtral-8x7b"), ShapeConfig("t", "train", S, B),
                             make_mesh(*mesh, device="cpu"),
                             ParallelConfig(param_sharding="replicated"))
    assert setup.ruleset.expert_sharded
    setup = make_train_setup(config("mamba2-1.3b"), ShapeConfig("t", "train", S, B),
                             make_mesh(*mesh, device="cpu"),
                             ParallelConfig(param_sharding="replicated"))
    assert setup.ruleset.tp == "model"
    assert setup.param_shardings["blocks"][0]["ssm"]["in_proj"] == (None, "model")


def test_compressed_sync_is_refused():
    with pytest.raises(ValueError, match="exact.*different result"):
        refused(ParallelConfig(param_sharding="zero1", grad_sync="compressed"),
                ((2, 2), ("pod", "data")))


def test_int8_moments_under_zero1_are_refused():
    """The name is historical: int8 moments under zero1 were refused while a
    rank's shard of a row took its own scale; now the scale is the whole
    row's (the max over the ranks that hold the row's pieces), and the
    setup builds for every sharding (``tests/test_torch_fsdp.py`` holds the
    moments equal to the replicated setup's)."""
    for sharding in ("zero1", "replicated", "fsdp"):
        refused(ParallelConfig(param_sharding=sharding),
                ocfg=OptimConfig(master=False, moments_dtype="int8"))


# --------------------------------------------------------------------------
# (ii) against the JAX setup on 8 host devices
# --------------------------------------------------------------------------

# a sharding with "-int8" takes int8 moments
JAX_ARCHS = {"llama3.2-1b": ("replicated", "zero1", "fsdp", "zero1-int8", "fsdp-int8"),
             "mixtral-8x7b": ("zero1", "fsdp")}

JAX_RUN = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as tfm
from repro.models.config import ParallelConfig, ShapeConfig
from repro.models.modules import split
from repro.parallel.steps import TrainState, make_train_setup
from repro.train.optim import OptimConfig, init_adam
ARCHS = {archs!r}
inp = dict(np.load(sys.argv[1]))
out = {{}}


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out[prefix + k] = np.asarray(v, np.float32)


mesh = make_mesh((4, 2), ("data", "model"))
for arch, shardings in ARCHS.items():
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    batch = {{k: jnp.asarray(inp[arch + "|" + k]) for k in ("tokens", "labels")}}
    B, S = batch["tokens"].shape
    for name in shardings:
        sharding, int8 = name.split("-")[0], name.endswith("-int8")
        ocfg = OptimConfig(**{ocfg!r}, **(dict(moments_dtype="int8") if int8 else {{}}))
        pcfg = ParallelConfig(param_sharding=sharding, remat="none",
                              param_dtype="float32", compute_dtype="float32")
        setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, ocfg)
        params = split(tfm.init(jax.random.PRNGKey(0), cfg))[0]
        with mesh:
            # the state placed by a jitted init, as tests/test_multidevice.py
            # places it (a device_put of the tree left the step's all-reduce
            # waiting on the CPU's collectives)
            state = jax.jit(lambda p: TrainState(p, init_adam(p, ocfg)),
                            out_shardings=setup.state_shardings)(params)
            state, m = setup.step_fn(state, batch)
        for k in ("loss", "aux_loss", "tokens", "grad_norm", "lr"):
            out[arch + "|" + name + "|" + k] = np.asarray(m[k], np.float32)
        flat(state.params, arch + "|" + name + "|p1|")
np.savez(sys.argv[2], **out)
print("JAX_SETUP_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_setup")
    inp = {}
    for arch in JAX_ARCHS:
        for k, v in make_batch(config(arch), 4).items():
            inp[arch + "|" + k] = v
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN.format(archs=JAX_ARCHS, ocfg=OCFG),
         str(d / "inputs.npz"), str(d / "jax.npz")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"JAX subprocess failed:\n{proc.stderr[-3000:]}"
    return inp, dict(np.load(d / "jax.npz"))


@pytest.mark.parametrize("arch,sharding", [(a, s) for a, ss in JAX_ARCHS.items() for s in ss])
def test_setup_equals_the_jax_setup_on_8_host_devices(jax_setup, arch, sharding):
    inp, out = jax_setup
    cfg = config(arch)
    batch = {k: inp[arch + "|" + k] for k in ("tokens", "labels")}
    placement, int8 = sharding.split("-")[0], sharding.endswith("-int8")
    case = {"zero1": "zero1-data4-flat", "fsdp": "fsdp-data4-flat",
            "replicated": "replicated-pod2-data2-hier"}[placement]
    setup = setup_of(cfg, case, OptimConfig(**OCFG, **(dict(moments_dtype="int8") if int8
                                                       else {})))
    state, metrics, _ = run_setup(setup, params_of(arch, "float32"), [batch])
    params = state.params
    if placement == "fsdp":
        specs = tree_flatten(setup.param_shardings, is_leaf=lambda x: isinstance(x, tuple))[0]
        _, struct = tree_flatten(params)
        params = tree_unflatten(struct, [unshard_leaf(r, sp, setup.mesh)
                                         for r, sp in zip(leaves(params), specs)])
    pre = arch + "|" + sharding + "|"
    for k in ("loss", "aux_loss", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[0][k]), float(out[pre + k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = from_jax_params(nest({k[len(pre) + 3:]: v for k, v in out.items()
                                 if k.startswith(pre + "p1|")}), cfg, device="cpu")
    for g, w in zip(leaves(params), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sharding", JAX_ARCHS["llama3.2-1b"])
def test_tp_setup_equals_the_jax_setup_on_8_host_devices(jax_setup, sharding):
    """The port's own (4, 2) ``data`` / ``model`` setup, tensor parallelism
    over ``model`` 2 (``parallel.tp``), against the JAX setup on the same
    mesh: one step from the converted weights, the metrics and every
    parameter after it (gathered whole), at the tolerances above."""
    arch = "llama3.2-1b"
    inp, out = jax_setup
    cfg = config(arch)
    batch = {k: inp[arch + "|" + k] for k in ("tokens", "labels")}
    placement, int8 = sharding.split("-")[0], sharding.endswith("-int8")
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh,
                             ParallelConfig(param_sharding=placement, remat="none"),
                             OptimConfig(**OCFG, **(dict(moments_dtype="int8") if int8 else {})))
    assert setup.ruleset.tp == "model"
    state, metrics, _ = run_setup(setup, params_of(arch, "float32"), [batch])
    specs = tree_flatten(setup.param_shardings, is_leaf=lambda x: isinstance(x, tuple))[0]
    params = [unshard_leaf(r, sp, mesh) for r, sp in zip(leaves(state.params), specs)]
    pre = arch + "|" + sharding + "|"
    for k in ("loss", "aux_loss", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[0][k]), float(out[pre + k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = from_jax_params(nest({k[len(pre) + 3:]: v for k, v in out.items()
                                 if k.startswith(pre + "p1|")}), cfg, device="cpu")
    for g, w in zip(params, leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# (iii) the distributed transport
# --------------------------------------------------------------------------

GLOO_WORKER = """
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.steps import make_train_setup
from repro_torch.train.optim import OptimConfig
CASES, GLOO_CASES, OCFG, B, S = {cases!r}, {gloo_cases!r}, {ocfg!r}, {B}, {S}
rank, store, inputs, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
inp = dict(np.load(inputs))
out = {{}}


def nest(items):
    tree = {{}}
    for path, v in items.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {{}})
        node[last] = v
    return tree


def nbytes(tree):
    return sum(t.untyped_storage().nbytes() for t in tree_flatten(tree)[0])


for n, (arch, dtype, case) in enumerate(GLOO_CASES):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    shape, axes, sharding, sync = CASES[case]
    mesh = make_dist_mesh(shape, axes, device="cpu")
    pcfg = ParallelConfig(param_sharding=sharding, grad_sync=sync, remat="none")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg,
                             OptimConfig(**OCFG))
    params = from_jax_params(nest({{k[len(arch) + 3:]: v for k, v in inp.items()
                                    if k.startswith(arch + "|p|")}}), cfg, device="cpu",
                             dtype=getattr(torch, dtype))
    state = setup.init_state(params)
    for field in ("master", "m", "v"):
        out[f"{{n}}|bytes|{{field}}"] = np.array(nbytes(getattr(state.opt, field)))
    batches = [{{k: inp[f"{{arch}}|b{{i}}|{{k}}"] for k in ("tokens", "labels")}}
               for i in range(2)]
    synced, m = setup.grad_fn(state, batches[0])
    for i, g in enumerate(tree_flatten(synced)[0]):
        out[f"{{n}}|g|{{i}}"] = g.float().numpy()
    state, om = setup.update_fn(state, synced)
    m2 = {{**m, **om}}
    state, m3 = setup.step_fn(state, batches[1])
    for s, mm in enumerate((m2, m3)):
        for k, v in mm.items():
            out[f"{{n}}|m{{s}}|{{k}}"] = v.float().numpy()
    for i, p in enumerate(tree_flatten(state.params)[0]):
        out[f"{{n}}|p|{{i}}"] = p.float().numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_setup")
    inp = {}
    for arch in {a for a, _, _ in GLOO_CASES}:
        for k, v in flat(_PARAMS.setdefault(arch, jax_params(arch))).items():
            inp[arch + "|p|" + k] = v
        for i, batch in enumerate((make_batch(config(arch), 5),
                                   make_batch(config(arch), 6, masked_shard=True))):
            for k, v in batch.items():
                inp[f"{arch}|b{i}|{k}"] = v
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    worker = GLOO_WORKER.format(cases=CASES, gloo_cases=GLOO_CASES, ocfg=OCFG, B=B, S=S)
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(rank), str(d / "gloo_store"),
         str(d / "inputs.npz"), str(d / f"rank_{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(4)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]   # one limit for the world
    finally:
        for p in procs:
            p.kill()
    bad = [(i, err[-2000:]) for i, (p, (_, err)) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"gloo ranks failed: {bad}"
    return inp, [dict(np.load(d / f"rank_{rank}.npz")) for rank in range(4)]


@pytest.mark.parametrize("n", range(len(GLOO_CASES)),
                         ids=["-".join(c) for c in GLOO_CASES])
def test_gloo_setup_equals_the_stacked_mesh(gloo_world, n):
    inp, ranks = gloo_world
    arch, dtype, case = GLOO_CASES[n]
    cfg = config(arch)
    batches = [{k: inp[f"{arch}|b{i}|{k}"] for k in ("tokens", "labels")} for i in range(2)]
    setup = setup_of(cfg, case)
    state, metrics, grads = run_setup(setup, params_of(arch, dtype), batches)
    for rank, res in enumerate(ranks):
        for i, g in enumerate(leaves(grads)):
            assert np.array_equal(res[f"{n}|g|{i}"], g.float().numpy()), (rank, i)
        for s, m in enumerate(metrics):
            for k, v in m.items():
                assert np.array_equal(res[f"{n}|m{s}|{k}"], v.float().numpy()), (rank, s, k)
        for i, p in enumerate(leaves(state.params)):
            assert np.array_equal(res[f"{n}|p|{i}"], p.float().numpy()), (rank, i)
    # a rank holds the whole optimizer state when replicated, a quarter of it
    # (every leaf has an embed dim over the 4 ranks of data) under zero1 on data 4
    full = {f: sum(t.untyped_storage().nbytes() for t in leaves(getattr(state.opt, f)))
            for f in ("master", "m", "v")}
    shard = {"zero1-data4-flat": 4, "replicated-pod2-data2-hier": 1,
             "zero1-pod2-data2-model1-hier": 2}[case]
    for rank, res in enumerate(ranks):
        for f, total in full.items():
            assert int(res[f"{n}|bytes|{f}"]) * shard == total, (rank, f)
