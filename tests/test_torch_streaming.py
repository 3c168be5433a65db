"""Weight streaming (``repro_torch.train.streaming``) on the CPU against the
JAX package.

Reduced configurations, B 2 x S 16, fp32 unless said; the same numpy inputs
and converted weights on both sides (``convert.from_jax_params``).
Tolerances: the loss to rtol 1e-5; a gradient leaf to atol 5e-6 and rtol
1e-4, as the reference's own streaming test
(``tests/test_substrate.py::test_streaming_grads_match_monolithic``).

  * llama3.2-1b (tied embedding) and mamba2-1.3b against the JAX
    ``stream_grads``, and bit for bit against the port's ``loss_fn``;
  * mixtral-8x7b and arctic-480b (its three-level ``ffn.dense.*`` tree)
    against ``jax.grad`` of the JAX ``loss_fn`` total, the router aux loss
    included: the port's stream matches ``loss_fn``, where the JAX
    ``stream_grads`` leaves the aux out (ROADMAP.md Queue 3);
  * a tokens-only llava batch runs as the dense family;
  * the update: on the same gradients the port's ``sgd_update`` gives the
    JAX ``stream_train_step``'s host weights bit for bit (fp32 and bf16);
    the update as each gradient lands equals all gradients first, then the
    update; three real steps of both packages lower the loss and stay close
    (their gradients differ by rounding, so their weights cannot be
    bit-equal);
  * the refusals.
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import modules as jmod
from repro.models import transformer as jtfm
from repro.models.config import ParallelConfig as JParallelConfig
from repro.train import streaming as jstream

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig
from repro_torch.models.modules import tree_flatten, tree_unflatten
from repro_torch.train import streaming as st

JPCFG = JParallelConfig(remat="none")
PCFG = ParallelConfig(remat="none")
ATOL, RTOL = 5e-6, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for this module's small tensors (the results do
    not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(arch, seed=0, **reduce):
    jcfg, cfg = j_get_config(arch).reduced(**reduce), get_config(arch).reduced(**reduce)
    jv, _ = jmod.split(jtfm.init(jax.random.PRNGKey(seed), jcfg))
    jv = jax.tree.map(np.asarray, jv)
    return jcfg, cfg, jv, from_jax_params(jv, cfg, device="cpu")


def make_batch(cfg, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                                  # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def port_grads(params, batch, cfg):
    """The port's monolithic ``loss_fn`` total and gradient."""
    leaves, spec = tree_flatten(params)
    live = [t.detach().clone().requires_grad_() for t in leaves]
    total, metrics = tfm.loss_fn(tree_unflatten(spec, live), torch_batch(batch), cfg, PCFG)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    return float(total.detach()), [torch.zeros_like(t) if g is None else g
                                   for t, g in zip(live, grads)]


def streamed(params, batch, cfg):
    """``stream_grads`` of the port on the CPU: (total, the gradients as a
    parameter tree, the host parameters)."""
    hp = st.HostParams(params, cfg.num_layers, device="cpu")
    total, g_top, layers = st.stream_grads(hp, torch_batch(batch), cfg, PCFG)
    return float(total), {**g_top, "blocks": layers}, hp


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_streamed_gradients_match_the_jax_stream_and_loss_fn(arch):
    jcfg, cfg, jv, params = setup(arch)
    batch = make_batch(cfg)
    total, grads, _ = streamed(params, batch, cfg)

    jloss, jtop, jlayers = jstream.stream_grads(jstream.HostParams(jv, jcfg.num_layers),
                                                jax.tree.map(jnp.asarray, batch), jcfg, JPCFG)
    assert total == pytest.approx(float(jloss), rel=1e-5)
    for i in range(cfg.num_layers):
        want = dict(leaves_with_paths(jlayers[i]))
        for path, got in leaves_with_paths(to_jax_params(
                {"blocks": [grads["blocks"][i]]}, cfg)["blocks"]):
            close(got[0], want[path], f"layer {i} {path}")
    for k in jtop:
        for path, want in leaves_with_paths(jtop[k]):
            close(dict(leaves_with_paths(grads[k])).get(path, grads[k]), want, f"top {k}")

    ref_total, ref = port_grads(params, batch, cfg)
    assert total == ref_total
    for a, b in zip(tree_flatten(grads)[0], ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_moe_stream_matches_the_jax_loss_fn_with_its_aux(arch):
    jcfg, cfg, jv, params = setup(arch)
    if arch == "arctic-480b":
        assert "dense" in params["blocks"][0]["ffn"]             # the third level
    batch = make_batch(cfg)
    total, grads, hp = streamed(params, batch, cfg)
    assert hp.stats["aux_loss"] > 0

    def jtotal(p):
        return jtfm.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg, JPCFG)[0]
    jt, jg = jax.value_and_grad(jtotal)(jax.tree.map(jnp.asarray, jv))
    assert total == pytest.approx(float(jt), rel=1e-5)
    want = dict(leaves_with_paths(jg))
    got = dict(leaves_with_paths(to_jax_params(grads, cfg)))
    assert got.keys() == want.keys()
    for path in want:
        close(got[path], want[path], str(path))

    ref_total, ref = port_grads(params, batch, cfg)
    assert total == ref_total
    for a, b in zip(tree_flatten(grads)[0], ref):
        assert torch.equal(a, b)


def test_the_jax_stream_leaves_the_moe_aux_out():
    """The reference's streamed loss is the cross-entropy alone; the port's
    is ``loss_fn``'s total.  This records the decision (ROADMAP.md Queue 3);
    it asserts no fault."""
    jcfg, cfg, jv, params = setup("mixtral-8x7b")
    batch = make_batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)
    jloss, _ = jstream.stream_forward(jstream.HostParams(jv, jcfg.num_layers), jb, jcfg, JPCFG)
    jt, jm = jtfm.loss_fn(jax.tree.map(jnp.asarray, jv), jb, jcfg, JPCFG)
    assert float(jloss) == pytest.approx(float(jm["loss"]), rel=1e-5)
    total, _, hp = streamed(params, batch, cfg)
    aux = hp.stats["aux_loss"]
    assert total == pytest.approx(float(jt), rel=1e-5)
    assert total == pytest.approx(hp.stats["loss"] + cfg.router_aux_weight * aux, rel=1e-6)
    assert abs(total - float(jloss)) > 0.5 * cfg.router_aux_weight * aux > 0


def test_a_tokens_only_vlm_batch_streams_as_the_dense_family():
    jcfg, cfg, jv, params = setup("llava-next-34b")
    batch = make_batch(cfg)
    total, grads, _ = streamed(params, batch, cfg)
    jt, jg = jax.value_and_grad(lambda p: jtfm.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), jcfg, JPCFG)[0])(jax.tree.map(jnp.asarray, jv))
    assert total == pytest.approx(float(jt), rel=1e-5)
    want = dict(leaves_with_paths(jg))
    for path, got in leaves_with_paths(to_jax_params(grads, cfg)):
        close(got, want[path], str(path))
    assert not grads["mm_proj"].any()                  # no patches: no gradient


def test_a_tied_embedding_gradient_is_the_heads_plus_the_lookups():
    jcfg, cfg, jv, params = setup("llama3.2-1b")
    assert cfg.tie_embeddings
    batch = make_batch(cfg)
    _, grads, hp = streamed(params, batch, cfg)
    # the head's part alone, from the streamed forward's last activation
    _, acts = st.stream_forward(hp, torch_batch(batch), cfg, PCFG)
    top = hp.top()
    emb = top["embed"].detach().requires_grad_()
    loss = st._head_loss({**top, "embed": emb}, acts[-1],
                         torch.from_numpy(batch["labels"].astype(np.int64)), cfg)
    (head,) = torch.autograd.grad(loss, emb)
    seen = np.zeros(cfg.padded_vocab, bool)
    seen[batch["tokens"].ravel()] = True
    g = grads["embed"]
    assert torch.equal(g[~torch.from_numpy(seen)], head[~torch.from_numpy(seen)])
    assert (g[torch.from_numpy(seen)] != head[torch.from_numpy(seen)]).any(dim=1).all()


def test_the_host_layout_round_trips():
    """Every leaf of every layer comes back where it was: the host tree
    equals the parameters, and ``layer`` / ``top`` give them back."""
    _, cfg, _, params = setup("mamba2-1.3b")
    hp = st.HostParams(params, cfg.num_layers, device="cpu")
    for a, b in zip(tree_flatten(hp.host)[0], tree_flatten(params)[0]):
        assert torch.equal(a, b)
    for i in range(cfg.num_layers):
        for a, b in zip(tree_flatten(hp.layer(i))[0], tree_flatten(params["blocks"][i])[0]):
            assert torch.equal(a, b)
    assert torch.equal(hp.top()["embed"], params["embed"])


# --------------------------------------------------------------------------
# the update
# --------------------------------------------------------------------------

def gradient_trees(jv, n_layers, seed, dtype):
    """Gradients shaped as the JAX parameters, drawn from a numpy seed: the
    JAX stream's (top, per-layer list) and the same tree stacked."""
    rng = np.random.default_rng(seed)
    full = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(dtype), jv)
    top = {k: v for k, v in full.items() if k != "blocks"}
    layers = [jax.tree.map(lambda a: a[i], full["blocks"]) for i in range(n_layers)]
    return full, top, layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_update_equals_the_jax_stream_train_step_bit_for_bit(dtype, monkeypatch):
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    jcfg, cfg, jv, _ = setup("llama3.2-1b")
    jv = jax.tree.map(lambda a: np.asarray(a).astype(np_dtype), jv)
    params = from_jax_params(jv, cfg, device="cpu", dtype=getattr(torch, dtype))
    jhp = jstream.HostParams(jv, jcfg.num_layers)
    hp = st.HostParams(params, cfg.num_layers, device="cpu")
    lr = 5e-3
    for step in range(3):
        full, top, layers = gradient_trees(jv, cfg.num_layers, step, np_dtype)
        monkeypatch.setattr(jstream, "stream_grads", lambda *a: (0.0, top, layers))
        jstream.stream_train_step(jhp, None, jcfg, JPCFG, lr=lr)
        g = from_jax_params(full, cfg, device="cpu", dtype=getattr(torch, dtype))
        for i in range(cfg.num_layers):
            hp.apply_grad_update(i, g["blocks"][i], st.sgd_update(lr))
        hp.apply_grad_update(None, {k: v for k, v in g.items() if k != "blocks"},
                             st.sgd_update(lr))
    want = dict(leaves_with_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), jhp.host)))
    got = dict(leaves_with_paths(to_jax_params(hp.host, cfg)))
    assert got.keys() == want.keys()
    changed = 0
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))
        changed += int((want[path] != np.asarray(jv_leaf(jv, path), np.float32)).sum())
    assert changed > 0


def jv_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_the_update_as_each_gradient_lands_equals_all_gradients_first(arch, dtype, monkeypatch):
    """``stream_train_step`` (each layer updated by the worker as its
    gradient lands, chunk by chunk through a small staging ring) against
    ``stream_grads`` then ``apply_grad_update`` of every layer and the top:
    bit for bit over three steps."""
    monkeypatch.setattr(st, "STAGING_BYTES", 1536)      # many chunks a layer
    _, cfg, _, params = setup(arch)
    params = tfm_cast(params, dtype)
    batch = torch_batch(make_batch(cfg))
    a = st.HostParams(params, cfg.num_layers, device="cpu")
    b = st.HostParams(params, cfg.num_layers, device="cpu")
    lr = 5e-2
    for _ in range(3):
        la = st.stream_train_step(a, batch, cfg, PCFG, lr=lr)
        total, g_top, layers = st.stream_grads(b, batch, cfg, PCFG)
        for i, g in enumerate(layers):
            b.apply_grad_update(i, g, st.sgd_update(lr))
        b.apply_grad_update(None, g_top, st.sgd_update(lr))
        assert la == float(total)
    assert a.stats["d2h_bytes"] > 1536 * 10
    for x, y in zip(tree_flatten(a.host)[0], tree_flatten(b.host)[0]):
        assert torch.equal(x, y)


def tfm_cast(params, dtype):
    return {k: ([tree_unflatten(tree_flatten(b)[1], [t.to(dtype) for t in tree_flatten(b)[0]])
                 for b in v] if k == "blocks" else v.to(dtype)) for k, v in params.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_streamed_steps_lower_the_loss_as_the_jax_ones_do(dtype):
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    jcfg, cfg, jv, _ = setup("llama3.2-1b")
    jv = jax.tree.map(lambda a: np.asarray(a).astype(np_dtype), jv)
    params = from_jax_params(jv, cfg, device="cpu", dtype=getattr(torch, dtype))
    batch = make_batch(cfg)
    jhp = jstream.HostParams(jv, jcfg.num_layers)
    hp = st.HostParams(params, cfg.num_layers, device="cpu")
    jb = jax.tree.map(jnp.asarray, batch)
    jl = [jstream.stream_train_step(jhp, jb, jcfg, JPCFG, lr=5e-3) for _ in range(3)]
    pl = [st.stream_train_step(hp, torch_batch(batch), cfg, PCFG, lr=5e-3) for _ in range(3)]
    assert jl[-1] < jl[0] and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-5 if dtype == "float32" else 2e-2)
    want = dict(leaves_with_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), jhp.host)))
    for path, got in leaves_with_paths(to_jax_params(hp.host, cfg)):
        np.testing.assert_allclose(got, want[path], atol=1e-5 if dtype == "float32" else 2e-2,
                                   rtol=1e-4 if dtype == "float32" else 2e-2, err_msg=str(path))


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra,match", [
    ("zamba2-2.7b", {}, "shared attention block"),
    ("whisper-medium", {}, "no encoder"),
    ("llava-next-34b", {"patch_embeds": np.zeros((2, 3, 8), np.float32)}, "patch_embeds"),
])
def test_what_the_stream_cannot_run_is_refused(arch, extra, match):
    cfg = get_config(arch).reduced()
    params = tfm.init(0, cfg, device="cpu")
    hp = st.HostParams(params, cfg.num_layers, device="cpu")
    batch = {**torch_batch(make_batch(cfg)), **extra}
    for fn in (st.stream_forward, st.stream_grads, st.stream_train_step):
        with pytest.raises(ValueError, match=match):
            fn(hp, batch, cfg, PCFG)


@pytest.mark.parametrize("kw", ["tp", "ep", "mesh"])
def test_a_multi_rank_stream_is_refused(kw):
    cfg = get_config("llama3.2-1b").reduced()
    hp = st.HostParams(tfm.init(0, cfg, device="cpu"), cfg.num_layers, device="cpu")
    with pytest.raises(ValueError, match="one device"):
        st.stream_grads(hp, torch_batch(make_batch(cfg)), cfg, PCFG, **{kw: object()})


def test_host_params_default_to_the_card():
    cfg = get_config("llama3.2-1b").reduced()
    params = tfm.init(0, cfg, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is taken")
    with pytest.raises(RuntimeError, match="cuda"):
        st.HostParams(params, cfg.num_layers)


def test_host_params_check_their_layers():
    cfg = get_config("llama3.2-1b").reduced()
    params = tfm.init(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="n_layers"):
        st.HostParams(params, cfg.num_layers + 1, device="cpu")
    odd = dict(params, blocks=[params["blocks"][0],
                               {**params["blocks"][1], "ln1": params["blocks"][1]["ln1"][:4]}])
    with pytest.raises(ValueError, match="block 1 differs"):
        st.HostParams(odd, cfg.num_layers, device="cpu")
    # a function of the layer index: the layers drawn one at a time
    hp = st.HostParams(dict(params, blocks=lambda i: params["blocks"][i]), cfg.num_layers,
                       device="cpu")
    for a, b in zip(tree_flatten(hp.host)[0], tree_flatten(params)[0]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 2])
def test_one_slot_and_two_give_the_same_gradients(slots, monkeypatch):
    """A slot that still holds the layer the backward needs is not copied
    again: one slot skips the forward's last layer (2L - 1 copies a pass),
    two slots its last two (2L - 2).  (The card's free memory chooses the
    ring's size; here the choice is substituted.)"""
    monkeypatch.setattr(st, "_choose_slots", lambda hp, work: (slots, "the test's"))
    _, cfg, _, params = setup("mixtral-8x7b", num_layers=3)
    batch = torch_batch(make_batch(cfg))
    hp = st.HostParams(params, cfg.num_layers, device="cpu")
    total, g_top, layers = st.stream_grads(hp, batch, cfg, PCFG)
    assert hp.stats["slots"] == slots
    assert hp.stats["h2d_layers"] == 2 * cfg.num_layers - slots
    ref_total, ref = port_grads(params, {k: v.numpy() for k, v in batch.items()}, cfg)
    assert float(total) == ref_total
    for a, b in zip(tree_flatten({**g_top, "blocks": layers})[0], ref):
        assert torch.equal(a, b)


def test_a_failing_update_raises_and_leaves_no_worker(monkeypatch):
    import threading

    def broken(lr):
        def update(w, g):
            raise FloatingPointError("planted")
        return update
    monkeypatch.setattr(st, "sgd_update", broken)
    _, cfg, _, params = setup("llama3.2-1b")
    hp = st.HostParams(params, cfg.num_layers, device="cpu")
    with pytest.raises(FloatingPointError, match="planted"):
        st.stream_train_step(hp, torch_batch(make_batch(cfg)), cfg, PCFG)
    assert not [t for t in threading.enumerate() if t.name == "stream-drain"]


@pytest.mark.parametrize("chunk_bytes", [6, 64, 1000, 1 << 20])
def test_the_layout_chunks_cover_every_element_once(chunk_bytes):
    """Leaves of two dtypes in one tree: each dtype's buffer holds its leaves
    in order, and the gradient stream's chunks cover each leaf's elements
    exactly once, in order."""
    tree = {"a": torch.arange(7, dtype=torch.float32),
            "b": [torch.ones(3, 5, dtype=torch.bfloat16),
                  torch.arange(11, dtype=torch.float32).reshape(11, 1)],
            "c": torch.zeros(2, dtype=torch.bfloat16)}
    layout = st._Layout(tree)
    assert layout.sizes == {torch.float32: 18, torch.bfloat16: 17}
    bufs = layout.buffers(torch.zeros(layout.nbytes, dtype=torch.uint8))
    for view, t in zip(layout.leaf_views(bufs), tree_flatten(tree)[0]):
        view.copy_(t)
    for a, b in zip(tree_flatten(layout.views(bufs))[0], tree_flatten(tree)[0]):
        assert torch.equal(a, b)
    seen = {i: [] for i in range(4)}
    for dt, a, b, pieces in layout.chunks(chunk_bytes):
        assert sum(hi - lo for _, lo, hi in pieces) == b - a
        assert (b - a) * dt.itemsize <= max(chunk_bytes, dt.itemsize)
        for i, lo, hi in pieces:
            seen[i].extend(range(lo, hi))
    for i, (_, _, shape) in enumerate(layout.places):
        assert seen[i] == list(range(math.prod(shape)))
