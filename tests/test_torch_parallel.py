"""The port's multi-rank layer (``launch.mesh``'s differentiable collectives,
``parallel.sharding``, ``models.moe.moe_ffn_ep``, ``parallel.steps.
moe_ep_ffn_fn``, ``parallel.pipeline``) on the CPU, held against the JAX
package in the same process, on the same numpy inputs and weights, fp32.

(a) ``Ruleset`` leaf for leaf against the JAX ``Ruleset``: every ``ARCH_ID``
    at full and at reduced size, on the meshes {data 4}, {data 4, model 2}
    and {pod 2, data 2, model 2}, under fsdp / zero1 / replicated, with and
    without ``moe_ep_axis="data"``: ``spec`` and ``opt_spec`` of every leaf
    of the JAX axes tree, ``batch_axes`` of B 8 and B 3, the EP axis and the
    flags.  The JAX ``Ruleset`` reads only ``mesh.shape`` there, so it gets
    a stand-in with that mapping (``test_jax_ruleset_reads_only_the_mesh_shape``
    checks the stand-in against a real JAX mesh).
(b) ``moe_ffn(n_groups=)`` against JAX for n in {1, 2, 4}, with and without
    drops; ``moe_ffn_ep`` on a ``StackedMesh`` against JAX ``moe_ffn(n_groups=
    n)`` for n 1 and 4 (mixtral and arctic, reduced): outputs, aux and every
    gradient (``jax.grad``).
(c) ``pipeline_fn`` on a ``StackedMesh`` against JAX ``sequential_reference``:
    the tanh stage of ``tests/test_multidevice.py`` (S 4, M 6) and stages of
    two reduced llama blocks, values and gradients.
(d) One spawned world of 4 ``gloo`` ranks (a ``file://`` store, one timeout
    for the world): ``moe_ffn_ep`` and ``pipeline_fn`` with their gradients,
    and the collectives themselves, on a ``DistMesh`` equal the
    ``StackedMesh`` results.

Tolerances: the port against JAX atol 1e-5 / rtol 1e-4 for the FFN and its
gradients and the tanh pipeline (fp32 products summed in another order), aux
atol 1e-6 / rtol 1e-5; the llama stages as ``tests/test_torch_train.py``
holds a model's gradients (relative 1e-4 of each leaf's largest magnitude
and Frobenius norm).  The distributed transport against the stacked one: bit
for bit where the same values go through the same operations (the pipeline,
the collectives, every rank's outputs), atol 1e-6 / rtol 1e-5 where a
product runs over another batch layout or a replicated weight's gradient is
summed over the ranks in another order.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as j_get_config
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.models import modules as jmod
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.config import ParallelConfig as JParallelConfig
from repro.models.layers import apply_attn_block as j_apply_attn_block
from repro.parallel.pipeline import sequential_reference as j_sequential_reference
from repro.parallel.sharding import Ruleset as JRuleset

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import all_to_all, make_mesh, pmean, ppermute
from repro_torch.models import modules, moe
from repro_torch.models.config import ParallelConfig
from repro_torch.models.layers import apply_attn_block
from repro_torch.parallel.pipeline import pipeline_fn, sequential_reference, stack_stages
from repro_torch.parallel.sharding import Ruleset, shard_leaf
from repro_torch.parallel.steps import moe_ep_ffn_fn

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
MOE = ["arctic-480b", "mixtral-8x7b"]
FFN_TOL = dict(atol=1e-5, rtol=1e-4)
AUX_TOL = dict(atol=1e-6, rtol=1e-5)
DIST_TOL = dict(atol=1e-6, rtol=1e-5)
MESHES = {"data4": {"data": 4}, "data4-model2": {"data": 4, "model": 2},
          "pod2-data2-model2": {"pod": 2, "data": 2, "model": 2}}


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))              # a writable copy


def as_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)
    fro = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert fro <= rel, f"{what}: Frobenius relative error {fro:.3e}"


def paths(tree, path=()):
    """(path, leaf) of every leaf of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, path + (i,))
    else:
        yield path, tree


# --------------------------------------------------------------------------
# (a) the rule table
# --------------------------------------------------------------------------

_AXES = {}


def jax_axes(arch, reduced):
    """The JAX axes tree's leaves (``split(tfm.init(...))[1]``), shapes only
    (``jax.eval_shape``), as tuples of logical names."""
    key = (arch, reduced)
    if key not in _AXES:
        jcfg = j_get_config(arch).reduced() if reduced else j_get_config(arch)
        holder = {}

        def f(k):
            vals, axes = jmod.split(jtfm.init(k, jcfg))
            holder["axes"] = axes
            return vals
        jax.eval_shape(f, jax.random.PRNGKey(0))
        leaves = jax.tree.leaves(holder["axes"],
                                 is_leaf=lambda a: isinstance(a, jmod.AxisNames))
        _AXES[key] = [tuple(a) for a in leaves]
    return _AXES[key]


def test_arch_ids_are_the_jax_ones():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)


def test_jax_ruleset_reads_only_the_mesh_shape():
    """A stand-in with the mesh's ``shape`` gives the JAX ``Ruleset`` what a
    real mesh of the same axes gives it (one host device: every axis of size
    1), on every leaf of two families."""
    mesh = j_make_mesh((1, 1), ("data", "model"))
    stand_in = types.SimpleNamespace(shape=dict(mesh.shape))
    for arch in ("mixtral-8x7b", "zamba2-2.7b"):
        cfg = j_get_config(arch)
        for pcfg in (JParallelConfig(), JParallelConfig(param_sharding="zero1",
                                                        moe_ep_axis="data")):
            real, fake = JRuleset(mesh, cfg, pcfg), JRuleset(stand_in, cfg, pcfg)
            for axes in jax_axes(arch, False):
                assert tuple(real.spec(axes)) == tuple(fake.spec(axes))
                assert tuple(real.opt_spec(axes)) == tuple(fake.opt_spec(axes))
            assert real.batch_axes(8) == fake.batch_axes(8)
            assert real.ep_axis == fake.ep_axis


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ruleset_equals_jax_leaf_for_leaf(arch, size, mesh_name):
    reduced = size == "reduced"
    jcfg = j_get_config(arch).reduced() if reduced else j_get_config(arch)
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    shape = MESHES[mesh_name]
    jmesh = types.SimpleNamespace(shape=dict(shape))
    # the port's Ruleset reads the shape of its own meshes
    mesh = make_mesh(tuple(shape.values()), tuple(shape), device="cpu")
    axes_leaves = jax_axes(arch, reduced)
    for sharding in ("fsdp", "zero1", "replicated"):
        for ep in ("", "data"):
            what = f"{arch} {size} {mesh_name} {sharding} ep={ep!r}"
            jr = JRuleset(jmesh, jcfg, JParallelConfig(param_sharding=sharding, moe_ep_axis=ep))
            r = Ruleset(mesh, cfg, ParallelConfig(param_sharding=sharding, moe_ep_axis=ep))
            for axes in axes_leaves:
                assert r.spec(axes) == tuple(jr.spec(axes)), f"{what} spec {axes}"
                assert r.opt_spec(axes) == tuple(jr.opt_spec(axes)), f"{what} opt_spec {axes}"
            for B in (8, 3):
                assert r.batch_axes(B) == jr.batch_axes(B), f"{what} batch_axes({B})"
            assert (r.ep_axis, r.dp, r.tp, r.tp_size, r.kv_head_sharded, r.expert_sharded) == \
                (jr.ep_axis, jr.dp, jr.tp, jr.tp_size, jr.kv_head_sharded,
                 jr.expert_sharded), what
            assert r.rules == jr.rules, what
            assert r.expert_mlp_axis == getattr(jr, "expert_mlp_axis", None), what


def test_spec_normalises_as_partition_spec():
    """A tuple of one axis is the axis, an empty one None, as
    ``tuple(PartitionSpec(...))`` has them."""
    from jax.sharding import PartitionSpec as P
    from repro_torch.parallel.sharding import _spec
    entries = [("data",), (), None, "model", ("pod", "data")]
    assert _spec(entries) == tuple(P(*entries))


def test_shard_leaf_on_the_stacked_mesh():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    got = shard_leaf(t, ("data",), mesh)
    assert got.shape == (2, 4, 6, 4) and got.data_ptr() == t.data_ptr()      # a view
    assert torch.equal(got[1], t[4:])
    # two axes on one dimension split pod-major; a second sharded dimension
    got = shard_leaf(t, (("pod", "data"), "model"), mesh)
    assert got.shape == (8, 2, 3, 4)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                blk = t[(2 * p + d) * 2:(2 * p + d + 1) * 2, 3 * m:3 * m + 3]
                assert torch.equal(got[(2 * p + d) * 2 + m], blk)
    assert torch.equal(shard_leaf(t, (None, None), mesh), t[None])
    with pytest.raises(ValueError, match="does not divide"):
        shard_leaf(t, (None, None, ("pod", "data", "model")), mesh)
    with pytest.raises(ValueError, match="twice"):
        shard_leaf(t, ("data", "data"), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        shard_leaf(t, ("pipe",), mesh)


# --------------------------------------------------------------------------
# the differentiable collectives on the stacked transport
# --------------------------------------------------------------------------

def test_all_to_all_ppermute_pmean_and_their_gradients():
    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    x = torch.randn(4, 4, 3, generator=torch.Generator().manual_seed(0), requires_grad=True)
    got = all_to_all(mesh, x, ("data",))
    for r in range(4):
        for j in range(4):
            assert torch.equal(got[r, j], x[j, r])
    ct = torch.randn(4, 4, 3, generator=torch.Generator().manual_seed(1))
    (got * ct).sum().backward()
    assert torch.equal(x.grad, ct.transpose(0, 1))          # the exchange of ct
    y = torch.randn(4, 5, generator=torch.Generator().manual_seed(2), requires_grad=True)
    got = ppermute(mesh, y, "data", 1)
    assert torch.equal(got, torch.roll(y, 1, 0))            # rank i gets rank i - 1's
    (got * ct[:, 0, :1]).sum().backward()
    assert torch.equal(y.grad, torch.roll(ct[:, 0, :1], -1, 0).expand(4, 5))
    a = torch.tensor([1.0, 2.0, 4.0, 8.0], requires_grad=True)
    m = pmean(mesh, a, ("data",))
    assert m.shape == () and float(m.detach()) == 3.75
    m.backward()
    assert torch.equal(a.grad, torch.full((4,), 0.25))
    assert mesh.row_coords("data") == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="rows form"):
        ppermute(mesh, y[:3], "data", 1)
    with pytest.raises(ValueError, match="blocks"):
        all_to_all(mesh, x[:, :3], ("data",))


# --------------------------------------------------------------------------
# (b) the grouped and the expert-parallel FFN
# --------------------------------------------------------------------------

def jax_moe_params(arch, cf=None):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jp, _ = jmod.split(jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jp


def jax_moe_grads(jp, x, ct, jcfg, n):
    def jloss(p, xx):
        o, a = jmoe.moe_ffn(p, xx, jcfg, n_groups=n)
        return jnp.sum(o * ct) + a, (o, a)
    (_, (jo, ja)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    return np.asarray(jo), float(ja), jax.tree.map(np.asarray, jg), np.asarray(jgx)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("cf", [0.5, 16.0], ids=["drops", "dropless"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_n_groups_matches_jax(arch, cf, n):
    """G groups of B·S/G tokens, the capacity from a group's tokens: output,
    aux and the gradient of ``sum(out * ct) + aux`` against ``jax.grad``."""
    jcfg, cfg, jp = jax_moe_params(arch, cf)
    x, ct = rnd((4, 12, cfg.d_model), 6), rnd((4, 12, cfg.d_model), 7)
    tp = modules.tree_map(lambda a: torch.tensor(a).requires_grad_(), jp)
    xt = T(x).requires_grad_()
    out, aux = moe.moe_ffn(tp, xt, cfg, n_groups=n)
    ((out * T(ct)).sum() + aux).backward()
    jo, ja, jg, jgx = jax_moe_grads(jp, x, ct, jcfg, n)
    np.testing.assert_allclose(as_np(out), jo, **FFN_TOL)
    np.testing.assert_allclose(float(aux.detach()), ja, **AUX_TOL)
    np.testing.assert_allclose(as_np(xt.grad), jgx, **FFN_TOL)
    for path, g in paths(tp):
        want = jg
        for p in path:
            want = want[p]
        np.testing.assert_allclose(as_np(g.grad), want, **FFN_TOL, err_msg=str(path))
    # the drops case drops, the dropless one does not
    T_g = 4 * 12 // n
    slot = moe._dispatch_indices(moe._route(xt.detach().reshape(n, T_g, -1), tp["router"].detach(),
                                            cfg.n_experts, cfg.top_k)[0],
                                 cfg.n_experts, moe.capacity_of(T_g, cfg))
    assert bool((slot < 0).any()) == (cf == 0.5)


def test_moe_ffn_default_groups_are_the_sequences():
    _, cfg, jp = jax_moe_params("mixtral-8x7b")
    tp = modules.tree_map(torch.tensor, jp)
    x = T(rnd((3, 10, cfg.d_model), 1))
    a, b = moe.moe_ffn(tp, x, cfg), moe.moe_ffn(tp, x, cfg, n_groups=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn(tp, x, cfg, n_groups=7)


def ep_inputs(jp, mesh):
    """The weights with the experts placed over ``data`` (``shard_leaf``);
    the whole tensors are the autograd leaves."""
    whole = modules.tree_map(lambda a: torch.tensor(a).requires_grad_(), jp)
    placed = dict(whole)
    for name in ("w_gate", "w_up", "w_down"):
        placed[name] = shard_leaf(whole[name], ("data",), mesh)
    return whole, placed


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_ep_on_the_stacked_mesh_matches_jax(arch, n):
    """``moe_ffn_ep`` over ``data`` n against JAX ``moe_ffn(n_groups=n)``:
    outputs, aux and every gradient through both exchanges."""
    jcfg, cfg, jp = jax_moe_params(arch)
    mesh = make_mesh((n,), ("data",), device="cpu")
    x, ct = rnd((4, 12, cfg.d_model), 8), rnd((4, 12, cfg.d_model), 9)
    whole, placed = ep_inputs(jp, mesh)
    xt = T(x).requires_grad_()
    out, aux = moe.moe_ffn_ep(placed, shard_leaf(xt, ("data",), mesh), cfg, mesh=mesh,
                              ep_axis="data")
    assert out.shape == (n, 4 // n, 12, cfg.d_model)
    out = out.reshape(4, 12, cfg.d_model)
    ((out * T(ct)).sum() + aux).backward()
    jo, ja, jg, jgx = jax_moe_grads(jp, x, ct, jcfg, n)
    np.testing.assert_allclose(as_np(out), jo, **FFN_TOL)
    np.testing.assert_allclose(float(aux.detach()), ja, **AUX_TOL)
    np.testing.assert_allclose(as_np(xt.grad), jgx, **FFN_TOL)
    for path, g in paths(whole):
        want = jg
        for p in path:
            want = want[p]
        np.testing.assert_allclose(as_np(g.grad), want, **FFN_TOL, err_msg=str(path))
    # the same buckets through the same products as moe_ffn(n_groups=n)
    ref, ref_aux = moe.moe_ffn(modules.tree_map(lambda t: t.detach(), whole), T(x), cfg,
                               n_groups=n)
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=1e-6, rtol=1e-6)
    assert float(aux) == float(ref_aux)


def test_moe_ffn_ep_refuses_what_does_not_divide():
    _, cfg, jp = jax_moe_params("mixtral-8x7b")       # 4 experts
    mesh = make_mesh((3,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        moe.moe_ffn_ep(modules.tree_map(torch.tensor, jp), torch.zeros(3, 1, 4, cfg.d_model),
                       cfg, mesh=mesh, ep_axis="data")
    mesh = make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="divide"):       # the batch not placed
        moe.moe_ffn_ep(modules.tree_map(torch.tensor, jp), torch.zeros(3, 4, cfg.d_model),
                       cfg, mesh=mesh, ep_axis="data")
    with pytest.raises(ValueError, match="shard the experts"):
        moe.moe_ffn_ep(modules.tree_map(torch.tensor, jp), torch.zeros(2, 1, 4, cfg.d_model),
                       cfg, mesh=mesh, ep_axis="data")
    with pytest.raises(ValueError, match="not an axis"):
        moe.moe_ffn_ep(modules.tree_map(torch.tensor, jp), torch.zeros(2, 1, 4, cfg.d_model),
                       cfg, mesh=mesh, ep_axis="model")
    with pytest.raises(ValueError, match="does not divide"):
        shard_leaf(torch.zeros(3, 4, cfg.d_model), ("data",), mesh)


def test_moe_ep_ffn_fn_requires_an_ep_axis():
    """As ``tests/test_multidevice.py::test_moe_ep_ffn_fn_requires_ep_axis``:
    expert parallelism is a decision, never a silent fallback; with the axis
    set the bound function equals ``moe_ffn`` with one group a rank, even at
    an EP degree of 1."""
    _, cfg, jp = jax_moe_params("mixtral-8x7b")
    mesh = make_mesh((1,), ("data",), device="cpu")
    rs = Ruleset(mesh, cfg, ParallelConfig())
    assert rs.ep_axis is None
    with pytest.raises(ValueError, match="moe_ep_axis"):
        moe_ep_ffn_fn(rs, cfg)
    rs = Ruleset(make_mesh((2,), ("data",), device="cpu"), get_config("mixtral-8x7b").reduced(),
                 ParallelConfig(moe_ep_axis="model"))           # not an axis of the mesh
    with pytest.raises(ValueError, match="moe_ep_axis"):
        moe_ep_ffn_fn(rs, cfg)
    rs = Ruleset(mesh, cfg, ParallelConfig(moe_ep_axis="data"))
    assert rs.ep_axis == "data"
    fn = moe_ep_ffn_fn(rs, cfg)
    tp = modules.tree_map(torch.tensor, jp)
    placed = {**tp, **{k: shard_leaf(tp[k], (rs.ep_axis,), mesh)
                       for k in ("w_gate", "w_up", "w_down")}}
    x = T(rnd((2, 8, cfg.d_model), 1))
    got, _ = fn(placed, shard_leaf(x, (rs.ep_axis,), mesh))
    ref, _ = moe.moe_ffn(tp, x, cfg, n_groups=1)
    np.testing.assert_allclose(as_np(got[0]), as_np(ref), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# (c) the pipeline
# --------------------------------------------------------------------------

def placed(stacked, mesh):
    """Stacked stage parameters placed over ``pipe`` (``shard_leaf``)."""
    return modules.tree_map(lambda t: shard_leaf(t, ("pipe",), mesh), stacked)


def tanh_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def tanh_case(S=4, M=6, B=3, D=8):
    """``tests/test_multidevice.py::test_pipeline_matches_sequential``'s
    stage and shapes, drawn with numpy."""
    return {"w": rnd((S, D, D), 0, 0.3), "b": rnd((S, D), 1, 0.1)}, rnd((M, B, D), 2), \
        rnd((M, B, D), 3)


def test_pipeline_tanh_matches_jax_sequential_reference():
    S, M = 4, 6
    params, x, ct = tanh_case(S, M)
    mesh = make_mesh((S,), ("pipe",), device="cpu")
    tp = {k: T(v).requires_grad_() for k, v in params.items()}
    xt = T(x).requires_grad_()
    y = pipeline_fn(tanh_stage, S, M, mesh)(placed(tp, mesh), xt)
    (y * T(ct)).sum().backward()

    def jstage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def jloss(p, xx):
        out = j_sequential_reference(jstage, p, xx, S)
        return jnp.sum(out * ct), out
    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    np.testing.assert_allclose(as_np(y), np.asarray(jy), **FFN_TOL)
    np.testing.assert_allclose(as_np(xt.grad), np.asarray(jgx), **FFN_TOL)
    for k in params:
        np.testing.assert_allclose(as_np(tp[k].grad), np.asarray(jg[k]), **FFN_TOL, err_msg=k)
    # the port's own oracle runs the same stages on the same inputs: bit for bit
    ref = sequential_reference(tanh_stage, {k: v.detach() for k, v in tp.items()}, T(x), S)
    assert torch.equal(y.detach(), ref)


def test_stack_stages_groups_consecutive_blocks():
    blocks = [{"w": torch.full((2,), float(l)), "n": {"g": torch.tensor(l)}} for l in range(6)]
    stages = stack_stages(blocks, 3)
    assert len(stages) == 2
    assert stages[0]["w"][:, 0].tolist() == [0.0, 2.0, 4.0]
    assert stages[1]["n"]["g"].tolist() == [1, 3, 5]
    with pytest.raises(ValueError, match="stages"):
        stack_stages(blocks, 4)


def test_pipeline_refuses_a_wrong_layout():
    params, x, _ = tanh_case()
    mesh = make_mesh((4,), ("pipe",), device="cpu")
    with pytest.raises(ValueError, match="stages need"):
        pipeline_fn(tanh_stage, 3, 6, mesh)
    run = pipeline_fn(tanh_stage, 4, 6, mesh)
    with pytest.raises(ValueError, match="leading"):
        run({k: T(v) for k, v in params.items()}, T(x))          # not placed
    with pytest.raises(ValueError, match="microbatches"):
        run(placed({k: T(v) for k, v in params.items()}, mesh), T(x[:5]))


def llama_stages(n_stages, per_stage, seed=0):
    """Reduced llama3.2-1b with ``n_stages * per_stage`` blocks: the JAX
    stacked blocks regrouped as (S, per_stage, ...), and the port's stage
    parameters (a list of ``per_stage`` blocks whose leaves lead with S),
    converted by ``from_jax_params``."""
    L = n_stages * per_stage
    jcfg = dataclasses.replace(j_get_config("llama3.2-1b").reduced(), num_layers=L)
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), num_layers=L)
    values, _ = jmod.split(jtfm.init(jax.random.PRNGKey(seed), jcfg))
    values = jax.tree.map(np.asarray, values)
    jstages = jax.tree.map(lambda a: a.reshape(n_stages, per_stage, *a.shape[1:]),
                           values["blocks"])
    stages = stack_stages(from_jax_params(values, cfg, device="cpu")["blocks"], n_stages)
    return jcfg, cfg, jstages, stages


def test_pipeline_of_llama_blocks_matches_jax():
    """Two stages of two reduced llama blocks each, 3 microbatches of 2 x 16
    tokens: the output and every gradient against ``jax.grad`` of the JAX
    ``sequential_reference`` over the same blocks."""
    S, per, M, B, L = 2, 2, 3, 2, 16
    jcfg, cfg, jstages, stages = llama_stages(S, per)
    x, ct = rnd((M, B, L, cfg.d_model), 4), rnd((M, B, L, cfg.d_model), 5)
    pcfg, jpcfg = ParallelConfig(remat="none"), JParallelConfig(remat="none")
    pos = torch.arange(L, dtype=torch.int32)[None].expand(B, L)
    jpos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None], (B, L))

    def stage(p, h):
        for bp in p:
            h = apply_attn_block(bp, cfg, pcfg, h, positions=pos)[0]
        return h

    def jstage(p, h):
        for j in range(per):
            h = j_apply_attn_block(jax.tree.map(lambda a: a[j], p), jcfg, jpcfg, h,
                                   positions=jpos)[0]
        return h

    live = modules.tree_map(lambda t: t.clone().requires_grad_(), stages)
    xt = T(x).requires_grad_()
    mesh = make_mesh((S,), ("pipe",), device="cpu")
    y = pipeline_fn(stage, S, M, mesh)(placed(live, mesh), xt)
    (y * T(ct)).sum().backward()

    def jloss(p, xx):
        out = j_sequential_reference(jstage, p, xx, S)
        return jnp.sum(out * ct), out
    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, jstages), jnp.asarray(x))
    np.testing.assert_allclose(as_np(y), np.asarray(jy), **FFN_TOL)
    rel_close(as_np(xt.grad), np.asarray(jgx), what="x")
    jg = jax.tree.map(np.asarray, jg)
    for path, g in paths(live):
        want = jg
        for p in path[1:]:
            want = want[p]
        rel_close(as_np(g.grad), want[:, path[0]], what=str(path))


# --------------------------------------------------------------------------
# (d) one world of 4 gloo ranks
# --------------------------------------------------------------------------

GLOO_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import all_to_all, make_dist_mesh, pmean, ppermute
from repro_torch.models import moe
from repro_torch.parallel.pipeline import pipeline_fn
from repro_torch.parallel.sharding import shard_leaf
rank, store, inputs, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
inp = dict(np.load(inputs))
out = {}
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
# the collectives on a (pod 2, data 2) mesh
mesh = make_dist_mesh((2, 2), ("pod", "data"), device="cpu")
row = lambda a: T(a)[mesh.replica(("data",))][None]     # this rank's row of the rows form
x = row(inp["a2a"]).requires_grad_()
got = all_to_all(mesh, x, ("data",))
(got * row(inp["a2a_ct"])).sum().backward()
out["a2a"], out["a2a_grad"] = got.detach().numpy(), x.grad.numpy()
y = row(inp["perm"]).requires_grad_()
got = ppermute(mesh, y, "data", 1)
(got * row(inp["perm_ct"])).sum().backward()
out["perm"], out["perm_grad"] = got.detach().numpy(), y.grad.numpy()
a = row(inp["mean"]).requires_grad_()
m = pmean(mesh, a, ("data",))
m.backward()
out["mean"], out["mean_grad"] = m.detach().numpy(), a.grad.numpy()
# expert parallelism over data 4: a rank's loss is its outputs' part and a
# quarter of aux, so that the ranks' losses sum to the stacked mesh's loss
mesh = make_dist_mesh((4,), ("data",), device="cpu")
for arch in ("mixtral-8x7b", "arctic-480b"):
    cfg = get_config(arch).reduced()
    whole = {k[len(arch) + 3:]: T(v).requires_grad_() for k, v in inp.items()
             if k.startswith(arch + "|w|")}
    params = {k: whole[k] for k in whole if "/" not in k}
    if cfg.moe_dense_ff:
        params["dense"] = {k.split("/")[1]: whole[k] for k in whole if "/" in k}
    for k in ("w_gate", "w_up", "w_down"):
        params[k] = shard_leaf(whole[k], ("data",), mesh)
    xs = shard_leaf(T(inp[arch + "|x"]), ("data",), mesh).clone().requires_grad_()
    o, aux = moe.moe_ffn_ep(params, xs, cfg, mesh=mesh, ep_axis="data")
    ((o * shard_leaf(T(inp[arch + "|ct"]), ("data",), mesh)).sum() + aux / 4).backward()
    out[arch + "|out"], out[arch + "|aux"] = o.detach().numpy(), aux.detach().numpy()
    out[arch + "|gx"] = xs.grad.numpy()
    for k, v in whole.items():
        out[arch + "|g|" + k] = v.grad.numpy()
# the tanh pipeline over pipe 4: the loss weighted by whether this is the last stage
mesh = make_dist_mesh((4,), ("pipe",), device="cpu")
tp = {k: T(inp["pipe|" + k]).requires_grad_() for k in ("w", "b")}
xm = T(inp["pipe|x"]).requires_grad_()
stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
yp = pipeline_fn(stage, 4, 6, mesh)({k: shard_leaf(v, ("pipe",), mesh) for k, v in tp.items()},
                                   xm)
last = float(mesh.row_coords("pipe")[0] == 3)
((yp * T(inp["pipe|ct"])).sum() * last).backward()
out["pipe|y"], out["pipe|gx"] = yp.detach().numpy(), xm.grad.numpy()
for k in tp:
    out["pipe|g|" + k] = tp[k].grad.numpy()
    tp[k].grad = None
# again with microbatches that need no gradient: the early ticks' shifts of
# the later stages still take part in the backward
yp = pipeline_fn(stage, 4, 6, mesh)({k: shard_leaf(v, ("pipe",), mesh) for k, v in tp.items()},
                                   xm.detach())
((yp * T(inp["pipe|ct"])).sum() * last).backward()
for k in tp:
    out["pipe|g2|" + k] = tp[k].grad.numpy()
out["coords"] = np.array([int(mesh.coords["pipe"])])
np.savez(out_path, **out)
dist.destroy_process_group()
"""


def gloo_inputs():
    inp = {"a2a": rnd((2, 2, 3), 20), "a2a_ct": rnd((2, 2, 3), 21),
           "perm": rnd((2, 5), 22), "perm_ct": rnd((2, 5), 23),
           "mean": np.array([1.0, 3.0], np.float32)}
    for arch in ("mixtral-8x7b", "arctic-480b"):
        _, cfg, jp = jax_moe_params(arch)
        for path, v in paths(jp):
            inp[arch + "|w|" + "/".join(path)] = v
        inp[arch + "|x"] = rnd((4, 6, cfg.d_model), 24)
        inp[arch + "|ct"] = rnd((4, 6, cfg.d_model), 25)
    params, x, ct = tanh_case()
    inp.update({"pipe|w": params["w"], "pipe|b": params["b"], "pipe|x": x, "pipe|ct": ct})
    return inp


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_parallel")
    inp = gloo_inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(rank), str(d / "gloo_store"),
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


def test_gloo_collectives_equal_the_stacked_ones(gloo_world):
    inp, ranks = gloo_world
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    x = T(inp["a2a"]).requires_grad_()
    got = all_to_all(mesh, x, ("data",))
    (got * T(inp["a2a_ct"])).sum().backward()
    y = T(inp["perm"]).requires_grad_()
    perm = ppermute(mesh, y, "data", 1)
    (perm * T(inp["perm_ct"])).sum().backward()
    a = T(inp["mean"]).requires_grad_()
    m = pmean(mesh, a, ("data",))
    m.backward()
    for rank, res in enumerate(ranks):
        d = rank % 2                                          # (pod, data) row-major
        assert np.array_equal(res["a2a"][0], as_np(got[d]))
        assert np.array_equal(res["perm"][0], as_np(perm[d]))
        assert np.array_equal(res["mean"], as_np(m))
        # a gradient on the distributed mesh is that of the sum of the ranks'
        # losses; pmean's result is on both ranks of a data group, and each
        # rank's loss counts it, where the stacked mesh has it once
        assert np.array_equal(res["a2a_grad"][0], as_np(x.grad[d]))
        assert np.array_equal(res["perm_grad"][0], as_np(y.grad[d]))
        assert np.array_equal(res["mean_grad"][0], 2 * as_np(a.grad[d]))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_gloo_moe_ffn_ep_equals_the_stacked_mesh(gloo_world, arch):
    inp, ranks = gloo_world
    cfg = get_config(arch).reduced()
    mesh = make_mesh((4,), ("data",), device="cpu")
    whole = {k[len(arch) + 3:]: T(v).requires_grad_() for k, v in inp.items()
             if k.startswith(arch + "|w|")}
    params = {k: whole[k] for k in whole if "/" not in k}
    if cfg.moe_dense_ff:
        params["dense"] = {k.split("/")[1]: whole[k] for k in whole if "/" in k}
    for k in ("w_gate", "w_up", "w_down"):
        params[k] = shard_leaf(whole[k], ("data",), mesh)
    xs = shard_leaf(T(inp[arch + "|x"]), ("data",), mesh).clone().requires_grad_()
    out, aux = moe.moe_ffn_ep(params, xs, cfg, mesh=mesh, ep_axis="data")
    ((out * shard_leaf(T(inp[arch + "|ct"]), ("data",), mesh)).sum() + aux).backward()
    for r, res in enumerate(ranks):
        assert np.array_equal(res[arch + "|out"][0], as_np(out[r])), r
        assert float(res[arch + "|aux"]) == float(aux.detach())
        np.testing.assert_allclose(res[arch + "|gx"][0], as_np(xs.grad[r]), **DIST_TOL)
    for k, v in whole.items():
        if k in ("w_gate", "w_up", "w_down"):      # each rank's experts' gradients
            E = v.shape[0] // 4
            for r, res in enumerate(ranks):
                got = res[arch + "|g|" + k][r * E:(r + 1) * E]
                np.testing.assert_allclose(got, as_np(v.grad[r * E:(r + 1) * E]),
                                           **DIST_TOL, err_msg=f"{k} rank {r}")
                others = np.delete(res[arch + "|g|" + k], np.s_[r * E:(r + 1) * E], 0)
                assert not others.any()
        else:                                      # replicated: the ranks' sum
            got = sum(res[arch + "|g|" + k] for res in ranks)
            np.testing.assert_allclose(got, as_np(v.grad), **DIST_TOL, err_msg=k)


def test_gloo_pipeline_equals_the_stacked_mesh(gloo_world):
    inp, ranks = gloo_world
    mesh = make_mesh((4,), ("pipe",), device="cpu")
    tp = {k: T(inp["pipe|" + k]).requires_grad_() for k in ("w", "b")}
    xm = T(inp["pipe|x"]).requires_grad_()
    y = pipeline_fn(tanh_stage, 4, 6, mesh)(placed(tp, mesh), xm)
    (y * T(inp["pipe|ct"])).sum().backward()
    assert sorted(int(r["coords"][0]) for r in ranks) == [0, 1, 2, 3]
    for res in ranks:
        s = int(res["coords"][0])
        if s == 3:
            assert np.array_equal(res["pipe|y"], as_np(y))
        else:                                        # zeros off the last stage
            assert not res["pipe|y"].any()
        for k in tp:                                 # each rank's stage's gradient
            for run in ("g", "g2"):
                assert np.array_equal(res[f"pipe|{run}|{k}"][s], as_np(tp[k].grad[s])), (k, s)
                assert not np.delete(res[f"pipe|{run}|{k}"], s, 0).any()
        # only stage 0 takes in the microbatches
        want = as_np(xm.grad) if s == 0 else np.zeros_like(as_np(xm.grad))
        assert np.array_equal(res["pipe|gx"], want), s
