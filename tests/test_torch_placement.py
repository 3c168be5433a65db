"""The port's placement metadata (``models.transformer.param_axes``,
``parallel.sharding.Ruleset``'s specs, ``parallel.steps``' input / batch /
optimizer specs and ``make_layer_constrain``, ``launch.mesh.
make_production_mesh``, ``parallel.policy``) held leaf for leaf against the
JAX package, on the CPU, allocating nothing.

* ``param_axes(cfg)`` equals ``split(tfm.init(...))[1]`` for every arch at
  full size (the JAX side through ``jax.eval_shape``), every level walked;
  the port's own layout (``stacked=False``) has ``init``'s structure, one
  name a dimension, and its shapes equal the JAX shapes with the layer stack
  taken apart.
* Every spec function against the JAX one over the meshes (16, 16), (2, 16,
  16), (4,) ``data``, (4, 2) and (2, 2, 2), ``param_sharding`` replicated /
  zero1 / fsdp, ``moe_ep_axis`` unset and ``"data"``, ``seq_shard`` on and off.
  The JAX ``Ruleset`` reads only ``mesh.shape``, so it gets a stand-in with
  that mapping; ``NamedSharding`` is replaced there by a recorder of its spec
  and ``jax.lax.with_sharding_constraint`` by one that captures the spec the
  JAX closures ask for (``monkeypatch``, in this test only).  Specs compare
  as ``tuple(PartitionSpec)``.
* ``paper_defaults`` for every arch x ``SHAPES``, and ``cell_policy``.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.parallel.sharding as j_sharding
import repro.parallel.steps as j_steps
from repro.configs.registry import get_config as j_get_config
from repro.models import modules as jmod
from repro.models import transformer as jtfm
from repro.models.config import SHAPES as J_SHAPES
from repro.models.config import ParallelConfig as JParallelConfig
from repro.parallel import policy as j_policy
from repro.train.optim import OptimConfig as JOptimConfig

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES, ParallelConfig
from repro_torch.parallel import policy, steps
from repro_torch.parallel.sharding import Ruleset
from repro_torch.train.optim import OptimConfig

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "data4": {"data": 4},
          "data4-model2": {"data": 4, "model": 2},
          "pod2-data2-model2": {"pod": 2, "data": 2, "model": 2}}
KINDS = ("residual", "logits", "tokens", "q_heads", "kv_heads", "moe_buckets")
OCFGS = (dict(), dict(master=False, moments_dtype="int8"),
         dict(master=True, moments_dtype="bfloat16"))


class Recorded:
    """What the JAX code builds in place of a ``NamedSharding``: its spec."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def jax_specs(monkeypatch):
    """``NamedSharding`` recorded and ``with_sharding_constraint`` captured
    in the JAX package's sharding and steps modules; yields the list of
    captured specs."""
    captured = []
    monkeypatch.setattr(j_sharding, "NamedSharding", Recorded)
    monkeypatch.setattr(j_steps, "NamedSharding", Recorded)

    def constrain(x, s):
        captured.append(s.spec)
        return s.spec
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", constrain)
    return captured


_JAX = {}


def jax_tree(arch):
    """(values' shapes, axes) of the JAX ``init`` at full size, through
    ``jax.eval_shape`` (nothing allocated)."""
    if arch not in _JAX:
        holder = {}

        def f(k):
            vals, axes = jmod.split(jtfm.init(k, j_get_config(arch)))
            holder["axes"] = axes
            return vals
        _JAX[arch] = (jax.eval_shape(f, jax.random.PRNGKey(0)), holder["axes"])
    return _JAX[arch]


def plain(x):
    """A JAX-side tree as plain Python: dicts, a named tuple as (its name,
    its fields...), a recorded sharding as its spec, ``AxisNames`` as a tuple."""
    if isinstance(x, Recorded):
        return x.spec
    if isinstance(x, jmod.AxisNames):
        return tuple(x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(plain(v) for v in x)
    if isinstance(x, tuple):
        return x
    raise TypeError(type(x))


def port_plain(x):
    """The port's tree as ``plain`` has the JAX one (its specs are tuples)."""
    if isinstance(x, dict):
        return {k: port_plain(v) for k, v in x.items()}
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(port_plain(v) for v in x)
    if isinstance(x, tuple):
        return x
    raise TypeError(type(x))


def port_mesh(name):
    if name == "16x16":
        return make_production_mesh()
    if name == "2x16x16":
        return make_production_mesh(multi_pod=True)
    shape = MESHES[name]
    return make_mesh(tuple(shape.values()), tuple(shape), device="cpu")


def stand_in(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


# --------------------------------------------------------------------------
# the logical-axes tree
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_jax_at_full_size(arch):
    shapes, axes = jax_tree(arch)
    assert tfm.param_axes(get_config(arch)) == plain(axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_ports_own_layout_has_inits_structure_and_the_jax_shapes(arch):
    """Unstacked, each block's axes drop ``layers``; the meta-device tree
    ``init`` gives has the same structure, a name per dimension, and each
    tensor's shape is the JAX leaf's without its layer dimension."""
    cfg = get_config(arch)
    j_shapes, _ = jax_tree(arch)
    meta = tfm.init(None, cfg, dtype=torch.bfloat16, device="meta")

    def check(a, t, st, js, in_stack=False):
        if isinstance(a, dict):
            assert set(a) == set(t) == set(st) == set(js)
            for k in a:
                check(a[k], t[k], st[k], js[k], in_stack)
        elif isinstance(a, list):
            assert len(a) == len(t) == jax.tree.leaves(js)[0].shape[0]
            for ai, ti in zip(a, t):
                check(ai, ti, st, js, True)
        else:
            assert t.device.type == "meta" and t.dim() == len(a), (a, tuple(t.shape))
            if in_stack:
                assert st == ("layers",) + a and tuple(t.shape) == tuple(js.shape[1:])
            else:
                assert st == a and tuple(t.shape) == tuple(js.shape)

    check(tfm.param_axes(cfg, stacked=False), meta, tfm.param_axes(cfg), j_shapes)


def test_every_level_is_walked():
    """arctic's third level (``ffn.dense``), zamba2's ``shared_attn``,
    llava's ``mm_proj`` and whisper's encoder, cross-attention and ``ln_x``."""
    arctic = tfm.param_axes(get_config("arctic-480b"))
    assert arctic["blocks"]["ffn"]["dense"]["w_down"] == ("layers", "mlp_dense",
                                                          "embed_unsharded")
    assert tfm.param_axes(get_config("zamba2-2.7b"))["shared_attn"]["attn"]["wq"] == \
        ("embed", "qkv")
    assert tfm.param_axes(get_config("llava-next-34b"))["mm_proj"] == ("embed", "embed_out")
    whisper = tfm.param_axes(get_config("whisper-medium"))
    assert whisper["blocks"]["cross"]["wk"] == ("layers", "embed", "kv")
    assert whisper["blocks"]["ln_x"] == ("layers", "embed")
    assert whisper["encoder"]["blocks"]["ffn"]["w_up"] == ("layers", "embed", "mlp")


# --------------------------------------------------------------------------
# the Ruleset's specs and the steps' metadata
# --------------------------------------------------------------------------

def settings():
    for sharding in ("replicated", "zero1", "fsdp"):
        for ep in ("", "data"):
            for seq in (True, False):
                yield dict(param_sharding=sharding, moe_ep_axis=ep, seq_shard=seq)


def constrain_cases(cfg, B):
    d, S, V = cfg.d_model, 64, cfg.padded_vocab
    H, Hkv, hd = max(cfg.n_heads, 1), max(cfg.n_kv_heads, 1), cfg.head_dim
    E = max(cfg.n_experts, 1)
    return [("residual", (B, S, d)), ("residual", (B, 7, d)), ("residual", (B, d)),
            ("logits", (B, S, V)), ("tokens", (B, S)),
            ("q_heads", (B, S, H, hd)), ("q_heads", (B, 1, H, hd)),
            ("kv_heads", (B, S, Hkv, hd)),
            ("moe_buckets", (B, E, 8, d)), ("moe_buckets", (B, E, 8, 3))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ruleset_metadata_equals_jax_leaf_for_leaf(arch, mesh_name, jax_specs):
    """``param_shardings``, ``act_spec`` of every kind, the spec
    ``constrain_fn`` pins (after its adjustments), ``kv_cache_spec``,
    ``ssm_state_spec``, ``decode_state_shardings``, ``batch_shardings`` and
    ``make_layer_constrain``'s block specs."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    _, jaxes = jax_tree(arch)
    axes = tfm.param_axes(cfg)
    mesh = port_mesh(mesh_name)
    for kw in settings():
        what = f"{arch} {mesh_name} {kw}"
        jr = j_sharding.Ruleset(stand_in(mesh_name), jcfg, JParallelConfig(**kw))
        r = Ruleset(mesh, cfg, ParallelConfig(**kw))
        assert port_plain(r.param_shardings(axes)) == plain(jr.param_shardings(jaxes)), what
        lc = steps.make_layer_constrain(r, axes["blocks"])
        del jax_specs[:]
        want = j_steps.make_layer_constrain(jr, jaxes["blocks"])(
            jax.tree.map(lambda a: np.zeros(()), jaxes["blocks"],
                         is_leaf=lambda a: isinstance(a, jmod.AxisNames)))
        assert lc == want, what
        if cfg.family == "audio":
            assert steps.make_layer_constrain(r, axes["encoder"]["blocks"]) == \
                j_steps.make_layer_constrain(jr, jaxes["encoder"]["blocks"])(
                    jax.tree.map(lambda a: np.zeros(()), jaxes["encoder"]["blocks"],
                                 is_leaf=lambda a: isinstance(a, jmod.AxisNames))), what
        for B in (8, 3, 1):
            for kind in KINDS:
                assert r.act_spec(kind, B) == tuple(jr.act_spec(kind, B)), (what, kind, B)
            jc, constrain = jr.constrain_fn(B), r.constrain_fn(B)
            for kind, shape in constrain_cases(cfg, B):
                del jax_specs[:]
                x = np.broadcast_to(np.int8(0), shape)
                jc(x, kind)
                got = r.constrain_spec(shape, kind, B)
                assert got == (jax_specs[0] if jax_specs else None), (what, kind, shape)
                t = torch.empty(shape, device="meta")
                assert constrain(t, kind) is t
            assert r.kv_cache_spec(B) == tuple(jr.kv_cache_spec(B)), (what, B)
            assert r.ssm_state_spec(B) == tuple(tuple(s) for s in jr.ssm_state_spec(B)), what
            assert port_plain(r.decode_state_shardings(cfg, B)) == \
                plain(jr.decode_state_shardings(jcfg, B)), (what, B)
        with pytest.raises(KeyError):
            r.act_spec("nothing", 8)
        for jshape, shape in zip(J_SHAPES, SHAPES):
            assert steps.batch_shardings(cfg, shape, r) == \
                plain(j_steps.batch_shardings(jcfg, jshape, jr)), (what, shape.name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_shardings_equal_jax(arch, mesh_name, jax_specs):
    """``opt_state_shardings`` under every optimizer memory mode the policy
    uses, int8 moments' ``QTensor`` (``scale`` the row's spec without its last
    entry) and no master included."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    _, jaxes = jax_tree(arch)
    axes = tfm.param_axes(cfg)
    mesh = port_mesh(mesh_name)
    for kw in settings():
        jr = j_sharding.Ruleset(stand_in(mesh_name), jcfg, JParallelConfig(**kw))
        r = Ruleset(mesh, cfg, ParallelConfig(**kw))
        for okw in OCFGS:
            got = steps.opt_state_shardings(r, axes, OptimConfig(**okw))
            want = j_steps.opt_state_shardings(jr, jaxes, JOptimConfig(**okw))
            assert port_plain(got) == plain(want), (arch, mesh_name, kw, okw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for jshape, shape in zip(J_SHAPES, SHAPES):
        for dt in ("bfloat16", "float32"):
            got = steps.input_specs(cfg, shape, ParallelConfig(compute_dtype=dt))
            want = j_steps.input_specs(jcfg, jshape, JParallelConfig(compute_dtype=dt))
            assert list(got) == list(want), shape.name
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (shape.name, k)
                assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), (shape.name, k)


def test_cell_setup_has_the_jax_fields():
    jax_fields = [f.name for f in dataclasses.fields(j_steps.CellSetup)]
    assert [f.name for f in dataclasses.fields(steps.CellSetup)][:len(jax_fields)] == jax_fields


def test_production_meshes():
    """(16, 16) ``(data, model)`` and (2, 16, 16) ``(pod, data, model)``,
    as the JAX ``make_production_mesh``, on the meta device."""
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert single.axis_names == ("data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert single.device.type == multi.device.type == "meta"
    r = Ruleset(multi, get_config("llama3.2-1b"), ParallelConfig())
    assert (r.dp, r.tp, r.tp_size) == (("pod", "data"), "model", 16)


# --------------------------------------------------------------------------
# the policy
# --------------------------------------------------------------------------

def as_dict(pcfg, ocfg):
    return dataclasses.asdict(pcfg), dataclasses.asdict(ocfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_paper_defaults_equal_jax(arch):
    for jshape, shape in zip(J_SHAPES, SHAPES):
        assert as_dict(*policy.paper_defaults(get_config(arch), shape)) == \
            as_dict(*j_policy.paper_defaults(j_get_config(arch), jshape)), shape.name
        assert as_dict(*policy.cell_policy(get_config(arch), shape, None)) == \
            as_dict(*j_policy.cell_policy(j_get_config(arch), jshape, None)), shape.name


def test_cell_policy_refuses_the_simulators_strategy():
    """``cell_policy(autostrategy=True, device="cpu")`` stamps the JAX
    decision, field for field.  (The name is historical: the port's policy
    refused the simulator's strategy until it had the decision stack.)"""
    got = policy.cell_policy(get_config("llama3.2-1b"), SHAPES[0], None,
                             autostrategy=True, device="cpu")
    want = j_policy.cell_policy(j_get_config("llama3.2-1b"), J_SHAPES[0], None,
                                autostrategy=True)
    assert as_dict(*got) == as_dict(*want)
    assert got[0].auto_strategy.is_set and got[0].auto_strategy.wafers == 2
    assert got[0].grad_sync == "hierarchical"
