"""Tensor parallelism over ``model`` (``parallel.tp`` and the TP path of the
setups in ``parallel.steps``) on the CPU, at reduced size, fp32.

References:

(i)   The operators against their one-device functions, on a
      ``StackedMesh`` with a ``model`` axis of 2 (alone, and beside a data
      axis): ``copy_to_tp`` / ``reduce_from_tp`` (forward and gradient, and
      ``torch.autograd.gradcheck`` in float64), the vocab-parallel lookup
      against ``table[tokens]``, the vocab-parallel cross-entropy against
      ``models.modules.softmax_cross_entropy`` with a padded vocab (the last
      rank's tail out of the sum), masked labels and a z-loss weight (loss
      and gradient rtol 1e-6 / atol 1e-7 in fp32; gradcheck in float64),
      ``gather_logits``.
(ii)  The TP setups against the one-device ``make_train_step`` /
      ``prefill`` / ``decode_step`` on the same converted weights
      (``convert.py``), for llama3.2-1b (tied head), qwen1.5-4b (qkv bias),
      qwen3-32b (qk-norm), llava-next-34b (patches) and whisper-medium
      (encoder, cross-attention), over ``(data 2, model 2)`` and ``(data 1,
      model 4)`` (``reduced(n_kv_heads=4)``) under replicated, zero1 and
      fsdp, block remat: the loss within 1e-5 relative, every synced
      gradient leaf and every updated parameter within 1e-5 absolute (the
      ranks' partials are rounded before their tree sum);
      the logits of a prefill and 4 decode steps within
      ``tests/test_torch_models.py``'s ``MODEL_TOL`` (atol 1e-4 / rtol
      1e-3), the decode state after the prefill atol 1e-5 + rtol 1e-4.
(iii) The all-reduces a step and a serving call run through
      ``ops.reduce_shards`` (the tree-reduce kernel on the card), counted
      against the formula ``chip_smoke.py`` asserts on the card; the flash
      calls at a rank's heads.
(iv)  One spawned world of 4 ``gloo`` ranks on ``(data 2, model 2)`` (a
      ``file://`` store, one timeout): an fsdp train step, a zero1 step with
      int8 moments, and a prefill + 2 decode steps of llama3.2-1b and
      whisper-medium, and of ``reduced(n_heads=3, n_kv_heads=1)`` (heads
      that do not divide the degree) an fsdp step and a prefill + 2 decode
      steps at B 8 and at B 1 (the flash-decoding layout), equal the
      ``StackedMesh``'s bit for bit.
(v)   The refusals once lifted: the moe, ssm and hybrid families build;
      heads that do not divide the degree build and run (their results are
      in ``tests/test_torch_moe_tp.py``, ``tests/test_torch_ssm_tp.py`` and
      ``tests/test_torch_heads_tp.py``); and a rank's parameter and
      optimizer bytes at ``(data 2, model 2)`` fsdp against the count from
      the specs.

The JAX setups on a ``(4, 2)`` ``data`` / ``model`` mesh are held against the
port's own TP setups in ``tests/test_torch_setup.py`` and
``tests/test_torch_serve_setup.py``, beside the subprocesses that run them.
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
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import softmax_cross_entropy, tree_flatten
from repro_torch.parallel import tp as tpm
from repro_torch.parallel.sharding import shard_leaf, unshard_leaf
from repro_torch.parallel.steps import (TrainState, _enc_fn, batch_to_device, make_setup,
                                        make_train_setup, make_train_step, train_grads)
from repro_torch.train.optim import OptimConfig, init_adam

from tests.test_torch_setup import SRC, clone, flat, leaves

ARCHS = ["llama3.2-1b", "qwen1.5-4b", "qwen3-32b", "llava-next-34b", "whisper-medium"]
B, S, NEW = 8, 16, 4
OCFG = dict(warmup_steps=0, eps=1e-6)
MESHES = {"data2-model2": (2, 2), "data1-model4": (1, 4)}
SHARDINGS = ("replicated", "zero1", "fsdp")
MODEL_TOL = dict(atol=1e-4, rtol=1e-3)
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
IS_SPEC = dict(is_leaf=lambda x: isinstance(x, tuple))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (as the other
    setup test files: beside the other test workers a pool of threads per
    op spends its time waiting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(mesh_name):
    """tp 4 needs 4 KV heads (the reduced configs have 2)."""
    return dict(n_kv_heads=4) if MESHES[mesh_name][1] == 4 else {}


def config(arch, **kw):
    return get_config(arch).reduced(**kw)


_JAX = {}


def jax_params(arch, **kw):
    """The JAX package's reduced parameters (seed 0) for ``reduced(**kw)``,
    as a numpy tree."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _JAX:
        import jax
        from repro.configs.registry import get_config as j_get_config
        from repro.models import transformer as jtfm
        from repro.models.modules import split
        jcfg = j_get_config(arch).reduced(**kw)
        vals = split(jtfm.init(jax.random.PRNGKey(0), jcfg))[0]
        _JAX[key] = jax.tree.map(np.asarray, vals)
    return _JAX[key]


def params_of(arch, **kw):
    return from_jax_params(jax_params(arch, **kw), config(arch, **kw), device="cpu")


def make_batch(cfg, seed, batch=B):
    """Tokens and labels (batch, S) with labels masked unevenly over the
    rows, and the family's patches or frames (0.02 N(0, 1))."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[rng.random((batch, S)) < np.arange(batch)[:, None] / 9] = -1
    out = {"tokens": toks[:, :-1].copy(), "labels": labels}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal((batch, cfg.n_patches, cfg.d_model))
                               * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((batch, cfg.enc_seq, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def specs_of(setup):
    return tree_flatten(setup.param_shardings, **IS_SPEC)[0]


def whole(setup, tree):
    """Every leaf of a tree in the rows form of the setup's specs, whole."""
    return [unshard_leaf(t, s, setup.mesh) for t, s in zip(leaves(tree), specs_of(setup))]


def tp_setup(cfg, mesh_name, sharding, ocfg=None, kind="train", cache=None):
    mesh = make_mesh(MESHES[mesh_name], ("data", "model"), device="cpu")
    if kind == "train":
        pcfg = ParallelConfig(param_sharding=sharding, grad_sync="flat", remat="block")
        return make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg,
                                ocfg or OptimConfig(**OCFG))
    return make_setup(cfg, ShapeConfig(kind, kind, cache, B), mesh,
                      ParallelConfig(param_sharding=sharding))


# --------------------------------------------------------------------------
# (i) the operators
# --------------------------------------------------------------------------

OP_MESHES = {"model2": ((2,), ("model",)), "data2-model2": ((2, 2), ("data", "model"))}


def op_mesh(name):
    return make_mesh(*OP_MESHES[name], device="cpu")


@pytest.mark.parametrize("mesh_name", OP_MESHES)
def test_copy_and_reduce_equal_their_one_device_functions(mesh_name):
    """f is the identity and its gradient the sum of the rows'; g is the sum
    of the rows and its gradient every row's; both in float64 through
    ``gradcheck``."""
    mesh = op_mesh(mesh_name)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=gen, requires_grad=True)
    rows = tpm.copy_to_tp(x, mesh, "model")
    assert rows.shape == (2, 3, 5) and torch.equal(rows[0], x) and torch.equal(rows[1], x)
    w = torch.randn(2, 3, 5, generator=gen)
    (rows * w).sum().backward()
    torch.testing.assert_close(x.grad, w.sum(0), rtol=0, atol=1e-6)
    parts = torch.randn(2, 3, 5, generator=gen, requires_grad=True)
    out = tpm.reduce_from_tp(parts, mesh, "model")
    torch.testing.assert_close(out, parts.sum(0), rtol=0, atol=1e-6)
    v = torch.randn(3, 5, generator=gen)
    (out * v).sum().backward()
    assert torch.equal(parts.grad, v.expand(2, 3, 5))
    x64 = torch.randn(3, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    p64 = torch.randn(2, 3, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: tpm.copy_to_tp(t, mesh, "model") ** 2, (x64,))
    assert torch.autograd.gradcheck(lambda t: tpm.reduce_from_tp(t, mesh, "model") ** 2,
                                    (p64,))
    with pytest.raises(ValueError, match="rows form"):
        tpm.reduce_from_tp(parts[:1], mesh, "model")


@pytest.mark.parametrize("mesh_name", OP_MESHES)
def test_vocab_parallel_lookup_equals_the_whole_table(mesh_name):
    mesh = op_mesh(mesh_name)
    gen = torch.Generator().manual_seed(1)
    V, d = 12, 4
    table = torch.randn(V, d, generator=gen, requires_grad=True)
    tokens = torch.tensor([[0, 5, 6, 11], [11, 3, 3, 7]])
    want = table[tokens]
    g = torch.randn(*want.shape, generator=gen)
    (want * g).sum().backward()
    rows = shard_leaf(table.detach(), ("model", None), mesh).clone().requires_grad_()
    got = tpm.vocab_parallel_embed(rows, tokens, mesh, "model")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (got * g).sum().backward()
    torch.testing.assert_close(unshard_leaf(rows.grad, ("model", None), mesh), table.grad,
                               rtol=0, atol=1e-6)
    r64 = rows.detach().double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: tpm.vocab_parallel_embed(t, tokens, mesh, "model"), (r64,))


CE_CASES = {"padded-masked": (250, 0.0), "z-loss": (256, 1e-3), "padded-z": (233, 1e-2)}


@pytest.mark.parametrize("case", CE_CASES)
@pytest.mark.parametrize("mesh_name", OP_MESHES)
def test_vocab_parallel_cross_entropy_equals_the_one_device_one(mesh_name, case):
    """The padded vocab's tail lies on the last rank (250 of 256: 6
    columns; 233: 23), labels < 0 are masked, ``z_weight`` adds ``z lse^2``;
    the loss, the count and the gradient of the logits as
    ``softmax_cross_entropy``'s, and the gradient through ``gradcheck`` in
    float64 (over a small vocab)."""
    vocab, z = CE_CASES[case]
    mesh = op_mesh(mesh_name)
    gen = torch.Generator().manual_seed(2)
    logits = torch.randn(3, 7, 256, generator=gen) * 3
    labels = torch.randint(0, vocab, (3, 7), generator=gen)
    labels[0, :3] = -1
    labels[2, 6] = -1
    x = logits.clone().requires_grad_()
    want, want_n = softmax_cross_entropy(x, labels, vocab, z)
    want.backward()
    rows = shard_leaf(logits, (None, None, "model"), mesh).clone().requires_grad_()
    got, n = tpm.vocab_parallel_cross_entropy(rows, labels, vocab, mesh, "model", z)
    assert float(n) == float(want_n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    got.backward()
    torch.testing.assert_close(unshard_leaf(rows.grad, (None, None, "model"), mesh), x.grad,
                               rtol=1e-6, atol=1e-7)
    small = (torch.randn(2, 5, 16, generator=gen, dtype=torch.float64) * 2)
    lab = torch.randint(0, vocab % 16 or 16, (2, 5), generator=gen)
    lab[1, 0] = -1
    r64 = shard_leaf(small, (None, None, "model"), mesh).clone().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: tpm.vocab_parallel_cross_entropy(t, lab, 13, mesh, "model", z)[0], (r64,))


@pytest.mark.parametrize("route", ["one-device", "tp"])
def test_the_cross_entropy_leaves_fp32_logits_as_they_were(route):
    """A padded vocab's columns are set to -3e38 inside the loss's fp32
    chunks: for fp32 logits those chunks must be copies (the one-device
    function wrote into the caller's logits through ``.float()``, which
    returns the tensor itself for fp32; fixed with this file)."""
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(2, 3, 16, generator=gen)
    labels = torch.randint(0, 13, (2, 3), generator=gen)
    before = logits.clone()
    if route == "one-device":
        x = logits.requires_grad_()
        softmax_cross_entropy(x, labels, 13)[0].backward()
    else:
        mesh = op_mesh("model2")
        x = shard_leaf(logits, (None, None, "model"), mesh).clone().requires_grad_()
        before = x.detach().clone()
        tpm.vocab_parallel_cross_entropy(x, labels, 13, mesh, "model")[0].backward()
    assert torch.equal(x.detach(), before)


def test_gather_logits_puts_the_vocab_back_together():
    mesh = op_mesh("data2-model2")
    x = torch.arange(2 * 3 * 8.).reshape(2, 3, 8)
    assert torch.equal(tpm.gather_logits(shard_leaf(x, (None, None, "model"), mesh), mesh,
                                         "model"), x)


# --------------------------------------------------------------------------
# (ii) the setups against the one-device path
# --------------------------------------------------------------------------

TRAIN_CASES = [(a, m, s) for a in ARCHS for m in MESHES for s in SHARDINGS]


def one_device_grads(params, batch, cfg, pcfg):
    return train_grads(params, batch, cfg, pcfg, _enc_fn(cfg, pcfg))[0]


@pytest.mark.parametrize("arch,mesh_name,sharding", TRAIN_CASES)
def test_tp_train_setup_equals_the_one_device_step(arch, mesh_name, sharding):
    kw = overrides(mesh_name)
    cfg = config(arch, **kw)
    ocfg = OptimConfig(**OCFG)
    pcfg = ParallelConfig(remat="none")
    p0 = params_of(arch, **kw)
    batch = make_batch(cfg, 1)
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    want_g = one_device_grads(ref.params, batch, cfg, pcfg)
    ref, m_ref = make_train_step(cfg, pcfg, ocfg)(ref, batch)

    setup = tp_setup(cfg, mesh_name, sharding)
    state = setup.init_state(clone(p0))
    synced, m = setup.grad_fn(state, batch)
    for g, w in zip(whole(setup, synced), leaves(want_g)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    state, om = setup.update_fn(state, synced)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)
    assert float(m["tokens"]) == float(m_ref["tokens"])
    np.testing.assert_allclose(float(om["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-5)
    for g, w in zip(whole(setup, state.params), leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def serve_batch(cfg, seed=11):
    batch = {k: v for k, v in make_batch(cfg, seed).items() if k != "labels"}
    rng = np.random.default_rng(seed + 1)
    return batch, [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
                   for _ in range(NEW)]


def cache_len(cfg):
    return S + (cfg.n_patches if cfg.family == "vlm" else 0) + NEW


def one_device_serve(cfg, params, batch, steps):
    pcfg = ParallelConfig(remat="none")
    logits, state = tfm.prefill(params, batch_to_device(batch, "cpu", torch.float32), cfg,
                                pcfg, cache_len(cfg), enc_fn=_enc_fn(cfg, pcfg))
    out, first = [logits], [t.clone() for t in tree_flatten(state)[0] if torch.is_tensor(t)]
    for tok in steps:
        logits, state = tfm.decode_step(params, torch.from_numpy(tok).long(), state, cfg, pcfg)
        out.append(logits)
    return out, first


def setup_serve(cfg, mesh_name, sharding, params, batch, steps):
    pre = tp_setup(cfg, mesh_name, sharding, kind="prefill", cache=cache_len(cfg))
    dec = tp_setup(cfg, mesh_name, sharding, kind="decode", cache=cache_len(cfg))
    placed = pre.init_state(params)
    logits, state = pre.step_fn(placed, batch)
    out, first = [logits], [t.clone() for t in tree_flatten(state)[0] if torch.is_tensor(t)]
    for tok in steps:
        logits, state = dec.step_fn(placed, state, tok)
        out.append(logits)
    return out, first


@pytest.mark.parametrize("arch,mesh_name,sharding", TRAIN_CASES)
def test_tp_serving_setups_equal_the_one_device_path(arch, mesh_name, sharding):
    kw = overrides(mesh_name)
    cfg = config(arch, **kw)
    p0 = params_of(arch, **kw)
    batch, steps = serve_batch(cfg)
    want, want_state = one_device_serve(cfg, p0, batch, steps)
    got, got_state = setup_serve(cfg, mesh_name, sharding, clone(p0), batch, steps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"step {i}", **MODEL_TOL)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), **STATE_TOL)


def test_a_padded_vocab_under_tp_equals_the_one_device_step():
    """llama3.2-1b with a vocab of 250 padded to 256 (the tied head's last
    rank holds the 6 padding rows, which the loss leaves out)."""
    cfg = config("llama3.2-1b", vocab_size=250)
    assert cfg.padded_vocab == 256
    ocfg, pcfg = OptimConfig(**OCFG), ParallelConfig(remat="none")
    p0 = tfm.init(0, cfg, device="cpu")
    batch = make_batch(cfg, 3)
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    want_g = one_device_grads(ref.params, batch, cfg, pcfg)
    ref, m_ref = make_train_step(cfg, pcfg, ocfg)(ref, batch)
    setup = tp_setup(cfg, "data2-model2", "fsdp")
    state = setup.init_state(clone(p0))
    synced, m = setup.grad_fn(state, batch)
    for g, w in zip(whole(setup, synced), leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    embed = unshard_leaf(synced["embed"], ("model", None), setup.mesh)
    assert float(embed[250:].abs().max()) == 0.0           # the padding rows
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)


# --------------------------------------------------------------------------
# (iii) the collectives a step runs
# --------------------------------------------------------------------------

def tp_reduce_launches(cfg, kind, remat=True):
    """Tree-reduce launches of one batch row's TP group (no data sync):
    ``chip_smoke.tp_tree_launches`` (the count asserted on the card)."""
    sys.path.insert(0, str(os.path.dirname(SRC)))
    from chip_smoke import tp_tree_launches
    return tp_tree_launches(cfg, kind, remat)


class Counting:
    """``ops.reduce_shards`` and ``ops.attention`` counted (every TP
    all-reduce and every flash call goes through them)."""

    def __init__(self, monkeypatch):
        self.reduce, self.attn, self.heads = 0, 0, set()
        plain_reduce, plain_attn = ops.reduce_shards, ops.attention

        def reduce(x, **kw):
            self.reduce += 1
            return plain_reduce(x, **kw)

        def attention(q, k, v, **kw):
            self.attn += 1
            self.heads.add((q.shape[2], k.shape[2]))
            return plain_attn(q, k, v, **kw)
        monkeypatch.setattr(ops, "reduce_shards", reduce)
        monkeypatch.setattr(ops, "attention", attention)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-32b", "whisper-medium"])
@pytest.mark.parametrize("sharding", ["zero1", "fsdp"])
def test_every_tp_all_reduce_goes_through_the_tree_reduce(monkeypatch, arch, sharding):
    """A step over (data 2, model 2): each batch row's TP group runs the
    counted all-reduces (g forward and in block remat's recompute, f's
    backward, the lookup's g, the loss's), then the sync over data; every
    flash call sees a rank's heads (H / 2 query, Hkv / 2 KV)."""
    cfg = config(arch)
    setup = tp_setup(cfg, "data2-model2", sharding)
    state = setup.init_state(params_of(arch))
    count = Counting(monkeypatch)
    setup.grad_fn(state, make_batch(cfg, 4))
    n_leaves = len(leaves(state.params))
    sharded = sum(1 for s in specs_of(setup) if "model" in [a for e in s if e for a in
                                                             ((e,) if isinstance(e, str) else e)])
    sync = n_leaves + (sharded if sharding == "fsdp" else 0)
    assert count.reduce == 2 * tp_reduce_launches(cfg, "train") + sync
    assert count.heads == {(cfg.n_heads // 2, cfg.n_kv_heads // 2)}
    attentions = cfg.num_layers + (cfg.num_layers + cfg.n_enc_layers
                                   if cfg.family == "audio" else 0)
    assert count.attn == 2 * 2 * 2 * attentions   # rows x ranks x (forward, recompute)


def test_a_tp_serving_call_runs_its_all_reduces(monkeypatch):
    cfg = config("whisper-medium")
    batch, steps = serve_batch(cfg)
    pre = tp_setup(cfg, "data2-model2", "fsdp", kind="prefill", cache=cache_len(cfg))
    dec = tp_setup(cfg, "data2-model2", "fsdp", kind="decode", cache=cache_len(cfg))
    placed = pre.init_state(params_of("whisper-medium"))
    count = Counting(monkeypatch)
    _, state = pre.step_fn(placed, batch)
    assert count.reduce == 2 * tp_reduce_launches(cfg, "prefill")
    count.reduce = 0
    dec.step_fn(placed, state, steps[0])
    assert count.reduce == 2 * tp_reduce_launches(cfg, "decode")


# --------------------------------------------------------------------------
# (v) refusals and bytes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw,match", [
    ("mixtral-8x7b", {}, "moe family.*M9b2b"),
    ("mamba2-1.3b", {}, "ssm family.*M9b2b"),
    ("zamba2-2.7b", {}, "hybrid family.*M9b2b"),
    ("llama3.2-1b", dict(n_heads=6, n_kv_heads=3), "heads do not divide.*M9b2b"),
    ("llama3.2-1b", {}, "heads do not divide.*M9b2b")])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_what_tp_does_not_run_is_refused(arch, kw, match, kind):
    """The names of these cases are historical: the moe, ssm and hybrid
    families under ``model`` 2 were refused (the match strings in their IDs)
    until tensor parallelism ran for them; now their setups build and place
    the experts, or the Mamba2 blocks' fused in-projection, over ``model``
    (``tests/test_torch_moe_tp.py`` and ``tests/test_torch_ssm_tp.py`` hold
    their results).  The llama cases, heads that do not divide the degree (6
    / 3 over ``model`` 2; 4 / 2 over ``model`` 4), were refused until the
    padded heads and the flash-decoding layout ran; now their setups build
    and run: a train step's loss, a prefill's logits and a decode step's
    against the one-device path (``tests/test_torch_heads_tp.py`` holds the
    rest)."""
    cfg = config(arch, **kw)
    mesh_name = "data1-model4" if not kw and arch == "llama3.2-1b" else "data2-model2"
    if cfg.family in ("moe", "ssm", "hybrid"):
        setup = tp_setup(cfg, mesh_name, "fsdp", kind=kind, cache=S)
        assert setup.ruleset.tp == "model"
        if cfg.family == "moe":
            assert setup.ruleset.expert_sharded
            assert setup.param_shardings["blocks"][0]["ffn"]["w_gate"] == \
                ("model", None, "data")
        else:
            assert setup.param_shardings["blocks"][0]["ssm"]["in_proj"] == ("data", "model")
        return
    p0 = tfm.init(0, cfg, device="cpu")
    if kind == "train":
        ocfg, pcfg = OptimConfig(**OCFG), ParallelConfig(remat="none")
        batch = make_batch(cfg, 2)
        ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
        _, m_ref = make_train_step(cfg, pcfg, ocfg)(ref, batch)
        setup = tp_setup(cfg, mesh_name, "fsdp")
        _, m = setup.step_fn(setup.init_state(clone(p0)), batch)
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-5)
        return
    batch, steps = serve_batch(cfg)
    want, _ = one_device_serve(cfg, p0, batch, steps[:1])
    pre = tp_setup(cfg, mesh_name, "fsdp", kind="prefill", cache=cache_len(cfg))
    placed = pre.init_state(clone(p0))
    got, state = pre.step_fn(placed, batch)
    assert pre.state_shardings.kv.k == (None, "data", "model", None, None)
    if kind == "decode":
        dec = tp_setup(cfg, mesh_name, "fsdp", kind="decode", cache=cache_len(cfg))
        got, _ = dec.step_fn(placed, state, steps[0])
    np.testing.assert_allclose(got.numpy(), want[kind == "decode"].numpy(), **MODEL_TOL)


def test_a_rank_holds_its_blocks_of_the_parameters():
    """fsdp over (data 2, model 2): a rank holds, of each leaf, the block of
    its spec: a quarter of a leaf over both axes, a half of one over either,
    all of a leaf over neither; the optimizer's master and moments the same."""
    cfg = config("llama3.2-1b")
    setup = tp_setup(cfg, "data2-model2", "fsdp")
    state = setup.init_state(params_of("llama3.2-1b"))
    want = 0                                   # fp32: 4 bytes an element
    for t, s in zip(tree_flatten(setup.param_shapes)[0], specs_of(setup)):
        axes = [a for e in s if e for a in ((e,) if isinstance(e, str) else e)]
        want += 4 * t.numel() // math.prod(setup.mesh.shape[a] for a in axes)
    got = sum(r[0].numel() * r.element_size() for r in leaves(state.params))
    assert got == want
    for field in ("master", "m", "v"):         # fp32 parameters: fp32 state alike
        assert sum(r[0].numel() * r.element_size()
                   for r in leaves(getattr(state.opt, field))) == want, field
    whole_bytes = sum(4 * t.numel() for t in tree_flatten(setup.param_shapes)[0])
    assert whole_bytes // 4 <= got < whole_bytes // 2


# --------------------------------------------------------------------------
# (iv) the distributed transport
# --------------------------------------------------------------------------

GLOO_TRAIN = [("llama3.2-1b", "fsdp", "float32"), ("llama3.2-1b", "zero1", "int8"),
              ("whisper-medium", "fsdp", "float32")]
GLOO_SERVE = ("llama3.2-1b", "whisper-medium")
# heads that do not divide model 2 (tests/test_torch_heads_tp.py): an fsdp
# step, and a prefill + 2 decode steps at B 8 (the caches' sequence over
# model) and at B 1 (over both axes), a cache of 21 slots padded to 22 / 24
GLOO_HEADS = ("llama3.2-1b-h3kv1", "llama3.2-1b", dict(n_heads=3, n_kv_heads=1))
GLOO_HEADS_BATCHES = (B, 1)

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
TRAIN, SERVE, OCFG, B, S, NEW = {train!r}, {serve!r}, {ocfg!r}, {B}, {S}, {new}
HEADS, HEADS_BATCHES = {heads!r}, {heads_batches!r}
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
name, arch, kw = HEADS
cfg = get_config(arch).reduced(**kw)
pcfg = ParallelConfig(param_sharding="fsdp", grad_sync="flat", remat="block")
setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, OptimConfig(**OCFG))
state = setup.init_state(params(name, cfg))
synced, m = setup.grad_fn(state, batch(name, "train"))
for i, g in enumerate(whole(synced, setup)):
    out[f"{{name}}|g|{{i}}"] = g.numpy()
state, om = setup.update_fn(state, synced)
for k, v in {{**m, **om}}.items():
    out[f"{{name}}|m|{{k}}"] = v.float().numpy()
for i, p in enumerate(whole(state.params, setup)):
    out[f"{{name}}|p|{{i}}"] = p.numpy()
for nb in HEADS_BATCHES:
    b = batch(name, f"serve{{nb}}")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", S + NEW + 1, nb), mesh, ParallelConfig())
    dec = make_setup(cfg, ShapeConfig("d", "decode", S + NEW + 1, nb), mesh, ParallelConfig())
    p = pre.init_state(params(name, cfg))
    logits, state = pre.step_fn(p, {{"tokens": b["tokens"]}})
    out[f"{{name}}|serve{{nb}}|0"] = logits.numpy()
    for t in range(2):
        logits, state = dec.step_fn(p, state, b[f"step{{t}}"])
        out[f"{{name}}|serve{{nb}}|{{t + 1}}"] = logits.numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_tp")
    inp = {}
    for arch in {a for a, _, _ in GLOO_TRAIN} | set(GLOO_SERVE):
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
    name, arch, kw = GLOO_HEADS
    cfg = config(arch, **kw)
    for k, v in flat(jax_params(arch, **kw)).items():
        inp[name + "|p|" + k] = v
    for k, v in make_batch(cfg, 6).items():
        inp[f"{name}|train|{k}"] = v
    for nb in GLOO_HEADS_BATCHES:
        sb, steps = serve_batch(cfg)
        inp[f"{name}|serve{nb}|tokens"] = sb["tokens"][:nb]
        for t, tok in enumerate(steps):
            inp[f"{name}|serve{nb}|step{t}"] = tok[:nb]
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    worker = GLOO_WORKER.format(train=GLOO_TRAIN, serve=GLOO_SERVE, ocfg=OCFG, B=B, S=S,
                                new=NEW, heads=GLOO_HEADS, heads_batches=GLOO_HEADS_BATCHES)
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
def test_gloo_tp_train_step_equals_the_stacked_mesh(gloo_world, n):
    """One step over (data 2, model 2) on 4 ``gloo`` ranks: the synced
    gradient, the metrics and the updated parameters (all-gathered whole)
    equal the ``StackedMesh``'s bit for bit on every rank."""
    inp, ranks = gloo_world
    arch, sharding, moments = GLOO_TRAIN[n]
    cfg = config(arch)
    ocfg = OptimConfig(**OCFG, **(dict(moments_dtype="int8") if moments == "int8" else {}))
    setup = tp_setup(cfg, "data2-model2", sharding, ocfg)
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
def test_gloo_tp_serving_equals_the_stacked_mesh(gloo_world, arch):
    """A prefill and two decode steps over (data 2, model 2): each rank its
    rows and its KV heads; the gathered logits equal the stacked mesh's bit
    for bit."""
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


def test_gloo_padded_heads_train_step_equals_the_stacked_mesh(gloo_world):
    """One fsdp step of ``reduced(n_heads=3, n_kv_heads=1)`` over (data 2,
    model 2) on 4 ``gloo`` ranks (the query heads padded to 2 a rank, rank 1
    of each TP group one; the KV columns, half a head a rank, gathered):
    equal to the ``StackedMesh``'s bit for bit on every rank."""
    inp, ranks = gloo_world
    name, arch, kw = GLOO_HEADS
    cfg = config(arch, **kw)
    setup = tp_setup(cfg, "data2-model2", "fsdp")
    state = setup.init_state(params_of(arch, **kw))
    synced, m = setup.grad_fn(state, _inputs(inp, name, "train"))
    grads = whole(setup, synced)
    state, om = setup.update_fn(state, synced)
    for rank, res in enumerate(ranks):
        for i, g in enumerate(grads):
            assert np.array_equal(res[f"{name}|g|{i}"], g.numpy()), (rank, i)
        for k, v in {**m, **om}.items():
            assert np.array_equal(res[f"{name}|m|{k}"], v.float().numpy()), (rank, k)
        for i, p in enumerate(whole(setup, state.params)):
            assert np.array_equal(res[f"{name}|p|{i}"], p.numpy()), (rank, i)


@pytest.mark.parametrize("batch", GLOO_HEADS_BATCHES)
def test_gloo_flash_decoding_equals_the_stacked_mesh(gloo_world, batch):
    """A prefill and two decode steps of the 3 / 1 config: at B 8 each rank
    keeps its block of its rows' caches over model, at B 1 its block over
    both axes, and the decode steps' combine runs over the ranks of the
    transport; the logits equal the stacked mesh's bit for bit."""
    inp, ranks = gloo_world
    name, arch, kw = GLOO_HEADS
    cfg = config(arch, **kw)
    b = _inputs(inp, name, f"serve{batch}")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", S + NEW + 1, batch), mesh,
                     ParallelConfig())
    dec = make_setup(cfg, ShapeConfig("d", "decode", S + NEW + 1, batch), mesh,
                     ParallelConfig())
    p = pre.init_state(params_of(arch, **kw))
    logits, state = pre.step_fn(p, {"tokens": b["tokens"]})
    want = [logits]
    for t in range(2):
        logits, state = dec.step_fn(p, state, b[f"step{t}"])
        want.append(logits)
    for rank, res in enumerate(ranks):
        for t, w in enumerate(want):
            assert np.array_equal(res[f"{name}|serve{batch}|{t}"], w.numpy()), (rank, t)
