"""The SSM and hybrid families (mamba2-1.3b, zamba2-2.7b) under tensor
parallelism over ``model``: ``parallel.tp.gather_from_tp``,
``models.ssm.mamba2_forward(tp=)`` and the TP path of the setups in
``parallel.steps``, on the CPU, at reduced size (8 SSM heads of hd 16, N 16;
zamba2's shared block 4 / 2 heads), fp32, on weights converted from the JAX
parameters (``convert.py``).

References:

(i)   The gather against ``torch.cat`` of the blocks: forward, the gradient
      of a rank's block (its block of the rows' summed gradients) and
      ``torch.autograd.gradcheck`` in float64, on ``model`` 2 alone and
      beside a data axis.
(ii)  ``mamba2_forward(tp=)`` against the one-device function over ``model``
      2 and ``data 2 x model 2`` (and ``model`` 4), for both families' mixers
      and a mixer of two B / C groups: the output, every parameter's
      gradient, the final state, and a prefill followed by 4 decode steps,
      each within 1e-5 absolute.
(iii) The setups against the one-device ``make_train_step`` / ``prefill`` /
      ``decode_step``, over ``(data 2, model 2)`` (flat and hierarchical
      sync) and ``(data 1, model 4)`` under replicated, zero1 and fsdp with
      block remat, int8 moments once per family: the loss within 1e-5
      relative, every synced gradient leaf and every updated parameter within
      1e-5 absolute, the logits of a prefill and 4 decode steps within
      ``MODEL_TOL``, the decode state after the prefill atol 1e-5 + rtol
      1e-4 (``tests/test_torch_tp.py``'s tolerances).
(iv)  The port's (4, 2) ``data`` / ``model`` setups against the JAX setups on
      8 host devices (one module-scoped subprocess): one train step's metrics
      and parameters under replicated, zero1 and fsdp, the logits of a
      prefill and 4 decode steps under fsdp.
(v)   One spawned world of 4 ``gloo`` ranks on ``(data 2, model 2)``: an fsdp
      step of mamba2, a zero1 step of zamba2 with int8 moments, and a prefill
      + 2 decode steps of each, bit-equal to the ``StackedMesh``.
(vi)  The tree-reduce launches of a step and of a serving call against
      ``chip_smoke.py::tp_tree_launches``; the SSD calls at a rank's heads;
      fsdp's gathers, the hybrid's shared block's included.
(vii) A rank's parameter, optimizer and decode-state bytes against the count
      from the specs; the fused columns and conv channels of both full
      configurations divide over ``model`` 2, 4 and 16.

And the refusals: SSM heads that do not divide the degree, and a rank's
heads that straddle B / C groups, each a ``ValueError`` naming ROADMAP.md
M9b2b.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.launch.mesh import StackedMesh, make_mesh
from repro_torch.models import ssm
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel import steps as steps_module
from repro_torch.parallel import tp as tpm
from repro_torch.parallel.sharding import Ruleset, shard_leaf, unshard_leaf
from repro_torch.parallel.steps import TrainState, make_setup, make_train_setup, make_train_step
from repro_torch.train.optim import OptimConfig, QTensor, init_adam

from tests.test_torch_moe_tp import check_train, sync_launches
from tests.test_torch_setup import SRC, clone, flat, leaves, nest
from tests.test_torch_tp import (MODEL_TOL, NEW, OCFG, STATE_TOL, Counting, cache_len,
                                 jax_params, make_batch, one_device_serve, params_of,
                                 serve_batch, specs_of, tp_reduce_launches, whole)
from tests.test_torch_tp import setup_serve as tp_setup_serve

B, S = 8, 16
ARCHS = ("mamba2-1.3b", "zamba2-2.7b")
MESHES = {"data2-model2": ((2, 2), ("data", "model")),
          "data1-model4": ((1, 4), ("data", "model"))}
SHARDINGS = ("replicated", "zero1", "fsdp")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (as the other
    setup test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(arch, mesh_name):
    """zamba2's shared block needs 4 KV heads at tp 4 (the reduced config
    has 2)."""
    tp = MESHES[mesh_name][0][1]
    return dict(n_kv_heads=4) if arch == "zamba2-2.7b" and tp == 4 else {}


def config(arch, **kw):
    return get_config(arch).reduced(**kw)


def setup_of(cfg, mesh_name, sharding, kind="train", ocfg=None, sync="flat"):
    mesh = make_mesh(*MESHES[mesh_name], device="cpu")
    if kind == "train":
        pcfg = ParallelConfig(param_sharding=sharding, grad_sync=sync, remat="block")
        return make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg,
                                ocfg or OptimConfig(**OCFG))
    return make_setup(cfg, ShapeConfig(kind, kind, cache_len(cfg), B), mesh,
                      ParallelConfig(param_sharding=sharding))


# --------------------------------------------------------------------------
# (i) the gather
# --------------------------------------------------------------------------

OP_MESHES = {"model2": ((2,), ("model",)), "data2-model2": ((2, 2), ("data", "model"))}


@pytest.mark.parametrize("mesh_name", OP_MESHES)
def test_the_gather_puts_the_blocks_together_and_sums_their_gradients(mesh_name):
    """Forward: every row the blocks side by side; backward: a rank's block
    of the gradient is its block of the sum of every row's gradient (a
    reduce-scatter), in float64 through ``gradcheck``."""
    mesh = make_mesh(*OP_MESHES[mesh_name], device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 10, generator=gen)
    rows = shard_leaf(x, (None, None, "model"), mesh).clone().requires_grad_()
    got = tpm.gather_from_tp(rows, mesh, "model")
    assert got.shape == (2, 3, 4, 10)
    assert torch.equal(got[0], x) and torch.equal(got[1], x)
    w = torch.randn(2, 3, 4, 10, generator=gen)
    (got * w).sum().backward()
    want = shard_leaf(w.sum(0), (None, None, "model"), mesh)
    torch.testing.assert_close(rows.grad, want, rtol=0, atol=1e-6)
    r64 = rows.detach().double().requires_grad_()
    assert torch.autograd.gradcheck(lambda t: tpm.gather_from_tp(t, mesh, "model") ** 2,
                                    (r64,))
    tp = tpm.TPContext(mesh, "model")
    assert torch.equal(tp.gather(rows.detach()), got.detach())
    with pytest.raises(ValueError, match="rows form"):
        tpm.gather_from_tp(rows[:1], mesh, "model")


# --------------------------------------------------------------------------
# (ii) the mixer
# --------------------------------------------------------------------------

MIXER_MESHES = {"model2": ((2,), ("model",)), "data2-model2": ((2, 2), ("data", "model")),
                "model4": ((4,), ("model",))}
MIXER_CASES = [("mamba2-1.3b", {}), ("zamba2-2.7b", {}), ("mamba2-1.3b", {"ssm_groups": 2})]


def mixer_rows(p, cfg, mesh):
    """A mixer's parameters in the rows form over ``model`` (the setups'
    ``spec``, replicated otherwise), leaves of a fresh graph."""
    rs = Ruleset(mesh, cfg, ParallelConfig(param_sharding="replicated"))
    specs = {k: rs.spec(a) for k, a in ssm.mamba2_axes(cfg).items()}
    assert specs["in_proj"] == (None, "model") and specs["a_log"] == ("model",)
    return ({k: shard_leaf(v, specs[k], mesh).clone().requires_grad_() for k, v in p.items()},
            specs)


@pytest.mark.parametrize("mesh_name", MIXER_MESHES)
@pytest.mark.parametrize("arch,kw", MIXER_CASES,
                         ids=["mamba2", "zamba2", "mamba2-groups2"])
def test_the_tp_mixer_equals_the_one_device_mixer(arch, kw, mesh_name):
    """Layer 0's converted mixer: the output, the final state and every
    parameter's gradient (of a loss of unit scale) of a prompt of 37
    tokens, then 4 decode steps from that state, each within 1e-5."""
    cfg = config(arch, **kw)
    mesh = make_mesh(*MIXER_MESHES[mesh_name], device="cpu")
    tp = tpm.TPContext(mesh, "model")
    p = params_of(arch, **kw)["blocks"][0]["ssm"]
    rows, specs = mixer_rows(p, cfg, mesh)
    gen = torch.Generator().manual_seed(3)
    u = torch.randn(3, 37, cfg.d_model, generator=gen)
    one = {k: v.clone().requires_grad_() for k, v in p.items()}
    want, want_st = ssm.mamba2_forward(one, u, cfg, return_state=True)
    got, got_st = ssm.mamba2_forward(rows, u, cfg, return_state=True, tp=tp)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-5)
    w = torch.randn(*want.shape, generator=gen) / math.sqrt(want.numel())
    (want * w).sum().backward()
    (got * w).sum().backward()
    for k in p:
        g = unshard_leaf(rows[k].grad, specs[k], mesh)
        assert g.shape == one[k].grad.shape
        np.testing.assert_allclose(g.numpy(), one[k].grad.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    with torch.no_grad():
        det = {k: v.detach() for k, v in rows.items()}
        st, want_st = got_st, ssm.SSMState(want_st.h.detach(), want_st.conv.detach())
        for t in range(1 + 4):
            assert st.h.shape == want_st.h.shape and st.conv.shape == want_st.conv.shape
            np.testing.assert_allclose(st.h.numpy(), want_st.h.numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(st.conv.numpy(), want_st.conv.numpy(), rtol=0,
                                       atol=1e-5)
            if t == 4:
                break
            x = torch.randn(3, 1, cfg.d_model, generator=gen)
            want, want_st = ssm.mamba2_forward(p, x, cfg, state=want_st, return_state=True)
            got, st = ssm.mamba2_forward(det, x, cfg, state=st, return_state=True, tp=tp)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"decode step {t}")


def test_the_groups_a_rank_reads():
    """``tp_groups``: a rank's heads cover whole groups, or lie in one."""
    cfg = config("mamba2-1.3b", ssm_groups=2)          # 8 heads, 4 a group
    assert ssm.tp_groups(cfg, 2) == [slice(0, 1), slice(1, 2)]
    assert ssm.tp_groups(cfg, 4) == [slice(0, 1), slice(0, 1), slice(1, 2), slice(1, 2)]
    assert ssm.tp_groups(config("mamba2-1.3b", ssm_groups=8), 2) == [slice(0, 4), slice(4, 8)]
    assert ssm.tp_groups(config("mamba2-1.3b"), 4) == [slice(0, 1)] * 4


# --------------------------------------------------------------------------
# (iii) the setups against the one-device path
# --------------------------------------------------------------------------

TRAIN_CASES = ([(a, "data2-model2", s, y) for a in ARCHS for s in SHARDINGS
                for y in ("flat", "hierarchical")] +
               [(a, "data1-model4", s, "flat") for a in ARCHS for s in SHARDINGS])


@pytest.mark.parametrize("arch,mesh_name,sharding,sync", TRAIN_CASES)
def test_ssm_tp_train_setup_equals_the_one_device_step(arch, mesh_name, sharding, sync):
    kw = overrides(arch, mesh_name)
    cfg = config(arch, **kw)
    setup = setup_of(cfg, mesh_name, sharding, sync=sync)
    assert setup.ruleset.tp == "model"
    check_train(cfg, params_of(arch, **kw), setup, make_batch(cfg, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_moments_under_ssm_tp_equal_the_one_device_step(arch):
    """fsdp with int8 moments over (data 2, model 2) against the one-device
    step with int8 moments: a row's scale is the whole row's, also where
    ``model`` splits it (the fused columns).  The loss and the parameters at
    the tolerances above; each stored moment within one quantization step
    (q within 1, the row scales rtol 1e-5: a gradient rounded otherwise may
    round a q the other way)."""
    cfg = config(arch)
    ocfg = OptimConfig(**OCFG, moments_dtype="int8")
    p0, batch = params_of(arch), make_batch(cfg, 2)
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    ref, m_ref = make_train_step(cfg, ParallelConfig(remat="none"), ocfg)(ref, batch)
    setup = setup_of(cfg, "data2-model2", "fsdp", ocfg=ocfg)
    state, m = setup.step_fn(setup.init_state(clone(p0)), batch)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)
    for g, w in zip(whole(setup, state.params), leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    specs = specs_of(setup)
    for field in ("m", "v"):
        got = tree_flatten(getattr(state.opt, field), is_leaf=lambda x: isinstance(x, QTensor))[0]
        want = tree_flatten(getattr(ref.opt, field), is_leaf=lambda x: isinstance(x, QTensor))[0]
        for g, w, s in zip(got, want, specs):
            q = unshard_leaf(g.q, s, setup.mesh)
            assert q.shape == w.q.shape
            assert int((q.int() - w.q.int()).abs().max()) <= 1, field
            # each rank's scales: those of the whole rows its block lies in
            rows = shard_leaf(w.scale[..., None].expand(w.q.shape), s, setup.mesh)[..., 0]
            np.testing.assert_allclose(g.scale.numpy(), rows.numpy(), rtol=1e-5, atol=0)


def test_a_mixer_of_two_groups_trains_under_tp():
    cfg = config("mamba2-1.3b", ssm_groups=2)
    setup = setup_of(cfg, "data1-model4", "fsdp")
    check_train(cfg, params_of("mamba2-1.3b", ssm_groups=2), setup, make_batch(cfg, 3))


SERVE_CASES = [(a, m, s) for a in ARCHS for m in MESHES for s in SHARDINGS]


@pytest.mark.parametrize("arch,mesh_name,sharding", SERVE_CASES)
def test_ssm_tp_serving_setups_equal_the_one_device_path(arch, mesh_name, sharding):
    """A prefill and 4 decode steps: the logits, and the decode state after
    the prefill (every layer's SSM state and conv lag, the hybrid's shared
    KV cache), held whole on the stacked mesh."""
    kw = overrides(arch, mesh_name)
    cfg = config(arch, **kw)
    p0 = params_of(arch, **kw)
    batch, steps = serve_batch(cfg)
    want, want_state = one_device_serve(cfg, p0, batch, steps)
    got, got_state = tp_setup_serve(cfg, mesh_name, sharding, clone(p0), batch, steps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"step {i}", **MODEL_TOL)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), **STATE_TOL)


# --------------------------------------------------------------------------
# (vi) the collectives, the SSD calls, the gathers
# --------------------------------------------------------------------------

class SSDCounting(Counting):
    """``Counting`` (tree reduces, flash calls) and every ``ops.ssd`` call
    with its heads."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        self.ssd, self.ssd_heads = 0, set()
        plain = ops.ssd

        def ssd_call(x, *a, **kw):
            self.ssd += 1
            self.ssd_heads.add(x.shape[2])
            return plain(x, *a, **kw)
        monkeypatch.setattr(ops, "ssd", ssd_call)


@pytest.mark.parametrize("arch,sharding", [("mamba2-1.3b", "fsdp"), ("zamba2-2.7b", "zero1"),
                                           ("zamba2-2.7b", "fsdp")])
def test_every_ssm_tp_all_reduce_goes_through_the_tree_reduce(monkeypatch, arch, sharding):
    """A step over (data 2, model 2): each batch row's TP group runs
    ``tp_tree_launches``'s all-reduces, then the sync; every SSD call sees a
    rank's heads (forward and block remat's recompute), every flash call of
    the hybrid's shared block a rank's query and KV heads."""
    cfg = config(arch)
    setup = setup_of(cfg, "data2-model2", sharding)
    state = setup.init_state(params_of(arch))
    count = SSDCounting(monkeypatch)
    setup.grad_fn(state, make_batch(cfg, 4))
    assert count.reduce == 2 * tp_reduce_launches(cfg, "train") + sync_launches(setup, sharding)
    assert count.ssd_heads == {cfg.ssm_heads // 2}
    assert count.ssd == 2 * 2 * 2 * cfg.num_layers      # rows x ranks x (forward, recompute)
    apps = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    assert count.attn == 2 * 2 * 2 * apps
    if apps:
        assert count.heads == {(cfg.n_heads // 2, cfg.n_kv_heads // 2)}


@pytest.mark.parametrize("arch", ARCHS)
def test_an_ssm_tp_serving_call_runs_its_all_reduces(monkeypatch, arch):
    cfg = config(arch)
    batch, steps = serve_batch(cfg)
    pre = setup_of(cfg, "data2-model2", "fsdp", kind="prefill")
    dec = setup_of(cfg, "data2-model2", "fsdp", kind="decode")
    placed = pre.init_state(params_of(arch))
    count = SSDCounting(monkeypatch)
    _, state = pre.step_fn(placed, batch)
    assert count.reduce == 2 * tp_reduce_launches(cfg, "prefill")
    assert count.ssd == 2 * 2 * cfg.num_layers and count.ssd_heads == {cfg.ssm_heads // 2}
    count.reduce, count.ssd = 0, 0
    dec.step_fn(placed, state, steps[0])
    assert count.reduce == 2 * tp_reduce_launches(cfg, "decode")
    assert count.ssd == 0                                 # decode: the O(1) recurrence


def test_fsdp_gathers_the_shared_block_once_a_row(monkeypatch):
    """zamba2 fsdp over (data 2, model 2): each batch row gathers every leaf
    outside the blocks once (the shared attention block's too: its ``embed``
    dim is over data), each Mamba2 block's leaves twice (forward and block
    remat's recompute); the shared block's synced gradient equals the
    one-device one (``test_ssm_tp_train_setup_equals_the_one_device_step``
    holds every leaf)."""
    cfg = config("zamba2-2.7b")
    setup = setup_of(cfg, "data2-model2", "fsdp")
    assert setup.param_shardings["shared_attn"]["attn"]["wq"] == ("data", "model")
    state = setup.init_state(params_of("zamba2-2.7b"))
    gathered = []
    plain = steps_module._tp_gather_fn

    def counting(*a, **kw):
        gather = plain(*a, **kw)

        def counted(rows, spec):
            gathered.append(rows.data_ptr())          # the state's storage
            return gather(rows, spec)
        return counted
    monkeypatch.setattr(steps_module, "_tp_gather_fn", counting)
    synced, _ = setup.grad_fn(state, make_batch(cfg, 5))
    shared = {t.data_ptr() for t in leaves(state.params["shared_attn"])}
    blocks = {t.data_ptr() for t in leaves(state.params["blocks"])}
    assert all(gathered.count(i) == 2 for i in shared)            # 2 batch rows
    assert all(gathered.count(i) == 2 * 2 for i in blocks)
    assert all(float(g.abs().max()) > 0 for g in leaves(synced["shared_attn"]))


# --------------------------------------------------------------------------
# (vii) bytes, divisibility
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_holds_its_blocks_of_the_mixer_and_of_the_state(arch):
    """fsdp over (data 2, model 2): a rank holds, of each leaf, the block of
    its spec (a quarter of ``in_proj``: ``embed`` over data, the fused
    columns over model); master and moments alike; the decode state's rows
    form holds every head and channel on the stacked mesh, a rank's block
    of them is a quarter."""
    cfg = config(arch)
    setup = setup_of(cfg, "data2-model2", "fsdp")
    state = setup.init_state(params_of(arch))
    want = 0
    for t, s in zip(tree_flatten(setup.param_shapes)[0], specs_of(setup)):
        axes = [a for e in s if e for a in ((e,) if isinstance(e, str) else e)]
        want += 4 * t.numel() // math.prod(setup.mesh.shape[a] for a in axes)
    got = sum(r[0].numel() * r.element_size() for r in leaves(state.params))
    assert got == want
    for field in ("master", "m", "v"):
        assert sum(r[0].numel() * r.element_size()
                   for r in leaves(getattr(state.opt, field))) == want, field
    P = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    assert state.params["blocks"][0]["ssm"]["in_proj"].shape == (4, cfg.d_model // 2, P // 2)
    pre = setup_of(cfg, "data2-model2", "fsdp", kind="prefill")
    h_spec, conv_spec = pre.state_shardings.ssm
    assert h_spec == (None, "data", "model", None, None)
    assert conv_spec == (None, "data", None, "model")
    _, st = pre.step_fn(pre.init_state(params_of(arch)), serve_batch(cfg)[0])
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    assert st.ssm.h.shape == (cfg.num_layers, B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    assert st.ssm.conv.shape == (cfg.num_layers, B, cfg.ssm_conv - 1, conv_dim)
    assert shard_leaf(st.ssm.h, h_spec, pre.mesh)[0].numel() * 4 == st.ssm.h.numel()
    assert shard_leaf(st.ssm.conv, conv_spec, pre.mesh)[0].numel() * 4 == st.ssm.conv.numel()


@pytest.mark.parametrize("tp", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_full_configs_divide_over_model(arch, tp):
    """mamba2-1.3b's 8512 fused columns and 4352 conv channels, zamba2-2.7b's
    10448 and 5248, over ``model`` 2, 4 and 16 (the JAX production mesh's):
    the train and serving setups build on the meta device, a rank's block of
    ``in_proj`` the columns over ``tp``."""
    cfg = get_config(arch)
    P = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    C = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    assert (P, C) == {"mamba2-1.3b": (8512, 4352), "zamba2-2.7b": (10448, 5248)}[arch]
    mesh = StackedMesh((2, tp), ("data", "model"), "meta")
    for sharding in SHARDINGS:
        setup = make_train_setup(cfg, ShapeConfig("t", "train", 4096, 8), mesh,
                                 ParallelConfig(param_sharding=sharding))
        spec = setup.param_shardings["blocks"][0]["ssm"]["in_proj"]
        assert spec[-1] == "model"
    for kind in ("prefill", "decode"):
        assert make_setup(cfg, ShapeConfig(kind, kind, 4096, 8), mesh).ruleset.tp == "model"


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_ssm_heads_that_do_not_divide_are_refused(kind):
    """6 SSM heads (d_model 48) over ``model`` 4: JAX's ``ssm_head`` rule
    replicates them there (padding them is ROADMAP.md M9b2b's item)."""
    cfg = config("mamba2-1.3b", d_model=48)
    assert cfg.ssm_heads == 6
    with pytest.raises(ValueError, match="6 SSM heads.*do not divide.*M9b2b"):
        setup_of(cfg, "data1-model4", "fsdp", kind=kind)
    with pytest.raises(ValueError, match="M9b2b"):
        ssm.mamba2_forward(None, torch.zeros(1, 2, 48), cfg,
                           tp=tpm.TPContext(make_mesh((4,), ("model",), device="cpu"),
                                            "model"))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_heads_that_straddle_groups_are_refused(kind):
    """12 SSM heads in 3 groups of 4 over ``model`` 2: a rank's 6 heads read
    two groups, one of them in part."""
    cfg = config("mamba2-1.3b", d_model=96, ssm_groups=3)
    assert cfg.ssm_heads == 12
    with pytest.raises(ValueError, match="straddle.*M9b2b"):
        setup_of(cfg, "data2-model2", "replicated", kind=kind)


# --------------------------------------------------------------------------
# (iv) against the JAX setups on 8 host devices
# --------------------------------------------------------------------------

JAX_TRAIN = ("replicated", "zero1", "fsdp")

JAX_RUN = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as tfm
from repro.models.config import ParallelConfig, ShapeConfig
from repro.models.modules import split
from repro.parallel.steps import (TrainState, make_decode_setup, make_prefill_setup,
                                  make_train_setup)
from repro.train.optim import OptimConfig, init_adam
ARCHS, TRAIN, OCFG, NEW = {archs!r}, {train!r}, {ocfg!r}, {new}
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
    batch = {{k: jnp.asarray(inp[arch + "|train|" + k]) for k in ("tokens", "labels")}}
    B, S = batch["tokens"].shape
    params = split(tfm.init(jax.random.PRNGKey(0), cfg))[0]
    for sharding in TRAIN:
        pcfg = ParallelConfig(param_sharding=sharding, remat="none", param_dtype="float32",
                              compute_dtype="float32")
        ocfg = OptimConfig(**OCFG)
        setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, ocfg)
        with mesh:
            state = jax.jit(lambda p: TrainState(p, init_adam(p, ocfg)),
                            out_shardings=setup.state_shardings)(params)
            state, m = setup.step_fn(state, batch)
        for k in ("loss", "tokens", "grad_norm"):
            out[arch + "|" + sharding + "|" + k] = np.asarray(m[k], np.float32)
        flat(state.params, arch + "|" + sharding + "|p1|")
    sb = {{"tokens": jnp.asarray(inp[arch + "|serve|tokens"])}}
    cache = int(inp[arch + "|cache"])
    pcfg = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    pre = make_prefill_setup(cfg, ShapeConfig("p", "prefill", cache, B), mesh, pcfg)
    dec = make_decode_setup(cfg, ShapeConfig("d", "decode", cache, B), mesh, pcfg)
    with mesh:
        p = jax.jit(lambda x: x, out_shardings=pre.param_shardings)(params)
        logits, state = pre.step_fn(p, sb)
        out[arch + "|serve|0"] = np.asarray(logits, np.float32)
        for i in range(NEW):
            logits, state = dec.step_fn(p, state, jnp.asarray(inp[f"{{arch}}|step{{i}}"]))
            out[f"{{arch}}|serve|{{i + 1}}"] = np.asarray(logits, np.float32)
np.savez(sys.argv[2], **out)
print("JAX_SSM_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_ssm(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ssm")
    inp = {}
    for arch in ARCHS:
        cfg = config(arch)
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
        [sys.executable, "-c", JAX_RUN.format(archs=ARCHS, train=JAX_TRAIN, ocfg=OCFG, new=NEW),
         str(d / "inputs.npz"), str(d / "jax.npz")],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, f"JAX subprocess failed:\n{proc.stderr[-3000:]}"
    return inp, dict(np.load(d / "jax.npz"))


@pytest.mark.parametrize("arch,sharding", [(a, s) for a in ARCHS for s in JAX_TRAIN])
def test_ssm_tp_train_setup_equals_the_jax_setup_on_8_host_devices(jax_ssm, arch, sharding):
    """One step of the port's (4, 2) setup (tensor parallelism over ``model``
    2) against the JAX one on the same mesh: the metrics and every parameter
    after it, gathered whole."""
    inp, out = jax_ssm
    cfg = config(arch)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh,
                             ParallelConfig(param_sharding=sharding, remat="none"),
                             OptimConfig(**OCFG))
    assert setup.ruleset.tp == "model"
    state, m = setup.step_fn(setup.init_state(params_of(arch)),
                             {k: inp[f"{arch}|train|{k}"] for k in ("tokens", "labels")})
    pre = f"{arch}|{sharding}|"
    for k in ("loss", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(out[pre + k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = from_jax_params(nest({k[len(pre) + 3:]: v for k, v in out.items()
                                 if k.startswith(pre + "p1|")}), cfg, device="cpu")
    for g, w in zip(whole(setup, state.params), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_tp_serving_setups_equal_the_jax_setups_on_8_host_devices(jax_ssm, arch):
    _, out = jax_ssm
    cfg = config(arch)
    batch, steps = serve_batch(cfg)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", cache_len(cfg), B), mesh)
    dec = make_setup(cfg, ShapeConfig("d", "decode", cache_len(cfg), B), mesh)
    assert pre.ruleset.tp == "model"
    placed = pre.init_state(params_of(arch))
    logits, state = pre.step_fn(placed, {"tokens": batch["tokens"]})
    got = [logits]
    for tok in steps:
        logits, state = dec.step_fn(placed, state, tok)
        got.append(logits)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), out[f"{arch}|serve|{i}"], err_msg=f"step {i}",
                                   **MODEL_TOL)


# --------------------------------------------------------------------------
# (v) the distributed transport
# --------------------------------------------------------------------------

GLOO_TRAIN = [("mamba2-1.3b", "fsdp", "float32"), ("zamba2-2.7b", "zero1", "int8")]
GLOO_SERVE = ARCHS

GLOO_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.sharding import unshard_leaf
from repro_torch.parallel.steps import TrainState, make_setup, make_train_setup, make_train_step
from repro_torch.train.optim import OptimConfig, QTensor, init_adam
TRAIN, SERVE, OCFG, B, S, NEW = {train!r}, {serve!r}, {ocfg!r}, {B}, {S}, {new}
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


def params(arch, cfg):
    pre = arch + "|p|"
    return from_jax_params(nest({{k[len(pre):]: v for k, v in inp.items()
                                  if k.startswith(pre)}}), cfg, device="cpu")


def batch(arch, name):
    pre = f"{{arch}}|{{name}}|"
    return {{k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}}


def whole(tree, setup):
    specs = tree_flatten(setup.param_shardings, **IS_SPEC)[0]
    return [unshard_leaf(t, s, setup.mesh) for t, s in zip(tree_flatten(tree)[0], specs)]


mesh = make_dist_mesh((2, 2), ("data", "model"), device="cpu")
for n, (arch, sharding, moments) in enumerate(TRAIN):
    cfg = get_config(arch).reduced()
    ocfg = OptimConfig(**OCFG, **(dict(moments_dtype="int8") if moments == "int8" else {{}}))
    pcfg = ParallelConfig(param_sharding=sharding, grad_sync="flat", remat="block")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, ocfg)
    state = setup.init_state(params(arch, cfg))
    synced, m = setup.grad_fn(state, batch(arch, "train"))
    for i, g in enumerate(whole(synced, setup)):
        out[f"{{n}}|g|{{i}}"] = g.numpy()
    state, om = setup.update_fn(state, synced)
    for k, v in {{**m, **om}}.items():
        out[f"{{n}}|m|{{k}}"] = v.float().numpy()
    for i, p in enumerate(whole(state.params, setup)):
        out[f"{{n}}|p|{{i}}"] = p.numpy()
for arch in SERVE:
    cfg = get_config(arch).reduced()
    b = batch(arch, "serve")
    cache = S + NEW
    pre = make_setup(cfg, ShapeConfig("p", "prefill", cache, B), mesh, ParallelConfig())
    dec = make_setup(cfg, ShapeConfig("d", "decode", cache, B), mesh, ParallelConfig())
    p = pre.init_state(params(arch, cfg))
    logits, state = pre.step_fn(p, {{k: v for k, v in b.items() if not k.startswith("step")}})
    out[f"{{arch}}|serve|0"] = logits.numpy()
    for t in range(2):
        logits, state = dec.step_fn(p, state, b[f"step{{t}}"])
        out[f"{{arch}}|serve|{{t + 1}}"] = logits.numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_ssm_tp")
    inp = {}
    for arch in ARCHS:
        cfg = config(arch)
        for k, v in flat(jax_params(arch)).items():
            inp[arch + "|p|" + k] = v
        for k, v in make_batch(cfg, 5).items():
            inp[f"{arch}|train|{k}"] = v
        sb, steps = serve_batch(cfg)
        for k, v in sb.items():
            inp[f"{arch}|serve|{k}"] = v
        for t, tok in enumerate(steps):
            inp[f"{arch}|serve|step{t}"] = tok
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    worker = GLOO_WORKER.format(train=GLOO_TRAIN, serve=GLOO_SERVE, ocfg=OCFG, B=B, S=S,
                                new=NEW)
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


def _inputs(inp, arch, name):
    pre = f"{arch}|{name}|"
    return {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}


@pytest.mark.parametrize("n", range(len(GLOO_TRAIN)), ids=["-".join(c) for c in GLOO_TRAIN])
def test_gloo_ssm_tp_train_step_equals_the_stacked_mesh(gloo_world, n):
    """One step over (data 2, model 2) on 4 ``gloo`` ranks: the synced
    gradient, the metrics and the updated parameters (all-gathered whole)
    equal the ``StackedMesh``'s bit for bit on every rank."""
    inp, ranks = gloo_world
    arch, sharding, moments = GLOO_TRAIN[n]
    cfg = config(arch)
    ocfg = OptimConfig(**OCFG, **(dict(moments_dtype="int8") if moments == "int8" else {}))
    setup = setup_of(cfg, "data2-model2", sharding, ocfg=ocfg)
    state = setup.init_state(params_of(arch))
    synced, m = setup.grad_fn(state, _inputs(inp, arch, "train"))
    grads = whole(setup, synced)
    state, om = setup.update_fn(state, synced)
    for rank, res in enumerate(ranks):
        for i, g in enumerate(grads):
            assert np.array_equal(res[f"{n}|g|{i}"], g.numpy()), (rank, i)
        for k, v in {**m, **om}.items():
            assert np.array_equal(res[f"{n}|m|{k}"], v.float().numpy()), (rank, k)
        for i, p in enumerate(whole(setup, state.params)):
            assert np.array_equal(res[f"{n}|p|{i}"], p.numpy()), (rank, i)


@pytest.mark.parametrize("arch", GLOO_SERVE)
def test_gloo_ssm_tp_serving_equals_the_stacked_mesh(gloo_world, arch):
    """A prefill and two decode steps over (data 2, model 2): each rank its
    rows, its SSM heads and conv channels (and the shared block's KV heads);
    the gathered logits equal the stacked mesh's bit for bit."""
    inp, ranks = gloo_world
    cfg = config(arch)
    b = _inputs(inp, arch, "serve")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", S + NEW, B), mesh, ParallelConfig())
    dec = make_setup(cfg, ShapeConfig("d", "decode", S + NEW, B), mesh, ParallelConfig())
    p = pre.init_state(params_of(arch))
    logits, state = pre.step_fn(p, {k: v for k, v in b.items() if not k.startswith("step")})
    want = [logits]
    for t in range(2):
        logits, state = dec.step_fn(p, state, b[f"step{t}"])
        want.append(logits)
    for rank, res in enumerate(ranks):
        for t, w in enumerate(want):
            assert np.array_equal(res[f"{arch}|serve|{t}"], w.numpy()), (rank, t)
