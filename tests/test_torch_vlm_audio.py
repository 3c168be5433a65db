"""The VLM (llava-next-34b: an image-patch prefix) and audio (whisper-medium:
encoder, cross-attention, static cross caches) families of the port on the
CPU, against the JAX package on the same numpy inputs and converted weights.

Reduced configurations (d_model 64, 2 layers, 8 patches, 16 encoder frames
unless a test says otherwise); patch embeddings and frames are 0.02 N(0, 1),
as ``tests/test_models.py`` draws them.  fp32 on both sides.  Tolerances:

* logits and hidden states: ``MODEL_TOL`` of ``tests/test_torch_models.py``
  (atol 1e-4 / rtol 1e-3), products summed in another order;
* the KV and cross caches: the same;
* the loss: rtol 1e-5; each gradient leaf: ``rel_close`` of
  ``tests/test_torch_train.py`` (every element within 1e-4 of the leaf's
  largest magnitude, the Frobenius error within 1e-4 of its norm);
* decode equals prefill inside the port: the reference's atol 2e-3 / rtol
  2e-2 (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import layers as jlayers
from repro.models import modules as jmod
from repro.models import transformer as jtfm
from repro.models import whisper as jwhisper
from repro.models.config import ParallelConfig as JParallelConfig
from repro.train import optim as jopt

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.models import layers, modules, whisper
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig
from repro_torch.parallel.steps import (TrainState, _enc_fn, batch_to_device,
                                        make_train_step)
from repro_torch.train import optim

from tests.test_torch_train import leaves_with_paths, rel_close

MODEL_TOL = dict(atol=1e-4, rtol=1e-3)
JPCFG = JParallelConfig(remat="none")
PCFG = ParallelConfig(remat="none")
LLAVA, WHISPER = "llava-next-34b", "whisper-medium"


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def converted(arch, seed=0, **overrides):
    jcfg = j_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jv, _ = jmod.split(jtfm.init(jax.random.PRNGKey(seed), jcfg))
    tp = from_jax_params(jax.tree.map(np.asarray, jv), cfg, device="cpu")
    return jcfg, cfg, jv, tp


def make_batch(cfg, B=2, S=12, seed=1, labels=False):
    """numpy tokens (and labels, three of them masked), and the family's
    patch embeddings or frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1]}
    if labels:
        batch["labels"] = toks[:, 1:].copy()
        batch["labels"][0, :3] = -1
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                                 * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                           * 0.02).astype(np.float32)
    return batch


def jax_enc(jcfg):
    if jcfg.family != "audio":
        return None
    return lambda p, b: jwhisper.encode(p, b, jcfg, JPCFG)


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# the encoder and one cross-attention block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [{}, dict(enc_seq=37, n_enc_layers=3)],
                         ids=["reduced", "enc37-3layers"])
def test_encode_matches_jax(overrides):
    """The encoder alone; at enc_seq 37 (ragged against every tile) and with
    3 encoder layers under 2 decoder layers, so that the converter's depth
    check reads ``n_enc_layers``."""
    jcfg, cfg, jv, tp = converted(WHISPER, **overrides)
    assert len(tp["encoder"]["blocks"]) == cfg.n_enc_layers
    batch = make_batch(cfg)
    got = whisper.encode(tp, tb(batch), cfg, PCFG)
    want = jwhisper.encode(jv, jb(batch), jcfg, JPCFG)
    assert tuple(got.shape) == (2, cfg.enc_seq, cfg.d_model)
    np.testing.assert_allclose(as_np(got), as_np(want), **MODEL_TOL)
    # remat changes nothing in the forward
    again = whisper.encode(tp, tb(batch), cfg, ParallelConfig(remat="block"))
    assert torch.equal(again, got)


def test_encoder_depth_is_checked_against_n_enc_layers():
    _, cfg, jv, _ = converted(WHISPER, n_enc_layers=3)
    vals = jax.tree.map(np.asarray, jv)
    with pytest.raises(ValueError, match="encoder blocks are stacked"):
        from_jax_params(vals, dataclasses.replace(cfg, n_enc_layers=2), device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_params({**vals, "mm_proj": np.zeros((2, 2))}, cfg, device="cpu")
    _, lcfg, lv, _ = converted(LLAVA)
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_params({**jax.tree.map(np.asarray, lv), "encoder": vals["encoder"]},
                        lcfg, device="cpu")


def test_cross_attention_block_prefill_and_decode_match_jax():
    """One decoder block with cross-attention alone: prefill over a ragged
    encoder output (its self cache and its cross cache), then decode steps
    that read the static cross cache and write only the self cache."""
    jcfg = j_get_config(WHISPER).reduced()
    cfg = get_config(WHISPER).reduced()
    jp, _ = jmod.split(jlayers.init_attn_block(jax.random.PRNGKey(3), jcfg, with_cross=True))
    assert {"ln_x", "cross"} <= set(jp)
    tp = from_jax_params(jax.tree.map(np.asarray, {
        "embed": np.zeros((1, 1), np.float32), "final_norm": np.zeros(1, np.float32),
        "blocks": jax.tree.map(lambda a: np.asarray(a)[None], jp),
        "encoder": {"blocks": jax.tree.map(lambda a: np.asarray(a)[None], jp),
                    "final_norm": np.zeros(1, np.float32)}}),
        dataclasses.replace(cfg, num_layers=1, n_enc_layers=1), device="cpu")["blocks"][0]
    rng = np.random.default_rng(4)
    B, S0, steps, Sk = 2, 9, 4, 21
    x = rng.standard_normal((B, S0 + steps, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, Sk, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S0 + steps, dtype=np.int32), (B, 1))
    jy, jc, jx, _ = jlayers.apply_attn_block(
        jp, jcfg, JPCFG, jnp.asarray(x[:, :S0]), positions=jnp.asarray(pos[:, :S0]),
        mode="prefill", cache_len=16, enc_out=jnp.asarray(enc))
    ty, tc, tx, taux = layers.apply_attn_block(
        tp, cfg, None, torch.from_numpy(x[:, :S0]), positions=torch.from_numpy(pos[:, :S0]),
        mode="prefill", cache_len=16, enc_out=torch.from_numpy(enc))
    assert float(taux) == 0.0 and tuple(tx.k.shape) == (B, Sk, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(as_np(ty), as_np(jy), **MODEL_TOL)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v), (tx.k, jx.k), (tx.v, jx.v)):
        np.testing.assert_allclose(as_np(a), as_np(b), **MODEL_TOL)
    cross_k = tx.k.clone()
    for t in range(S0, S0 + steps):
        jy, jc, jx2, _ = jlayers.apply_attn_block(
            jp, jcfg, JPCFG, jnp.asarray(x[:, t:t + 1]), positions=jnp.asarray(pos[:, t:t + 1]),
            mode="decode", cache=jc, cache_index=jnp.asarray(t, jnp.int32), cross_cache=jx)
        ty, tc, tx2, _ = layers.apply_attn_block(
            tp, cfg, None, torch.from_numpy(x[:, t:t + 1]),
            positions=torch.from_numpy(pos[:, t:t + 1]), mode="decode", cache=tc,
            cache_index=t, cross_cache=tx)
        assert tx2 is tx                          # the static cache, returned as it is
        np.testing.assert_allclose(as_np(ty), as_np(jy), **MODEL_TOL)
        np.testing.assert_allclose(as_np(tc.k), as_np(jc.k), **MODEL_TOL)
    assert torch.equal(tx.k, cross_k)             # decode writes no cross cache


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides", [(LLAVA, {}), (WHISPER, {}),
                                            (WHISPER, dict(enc_seq=37, n_enc_layers=3))],
                         ids=["llava", "whisper", "whisper-enc37-3layers"])
def test_loss_fn_and_every_gradient_match_jax(arch, overrides):
    """llava with its patch prefix (the labels padded with -1 over the
    patches, mm_proj's gradient), whisper through its encoder (every encoder
    gradient); against ``jax.grad`` of the JAX ``loss_fn``."""
    jcfg, cfg, jv, tp = converted(arch, **overrides)
    batch = make_batch(cfg, labels=True)
    leaves, spec = modules.tree_flatten(tp)
    live = [p.detach().clone().requires_grad_() for p in leaves]
    total, metrics = tfm.loss_fn(modules.tree_unflatten(spec, live), tb(batch), cfg, PCFG,
                                 enc_fn=_enc_fn(cfg, PCFG))
    total.backward()
    grads = modules.tree_unflatten(spec, [p.grad for p in live])
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jb(batch), jcfg, JPCFG, enc_fn=jax_enc(jcfg)),
        has_aux=True))(jv)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    # the patch positions predict nothing: the text's labels alone count
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == 2 * 12 - 3
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(leaves_with_paths(to_jax_params(grads, cfg)))
    assert got.keys() == want.keys()
    assert any(p[0] == ("mm_proj" if arch == LLAVA else "encoder") for p in got)
    for path in want:
        rel_close(got[path], want[path], 1e-4, "/".join(path))


def test_loss_and_prefill_without_the_encoder_raise():
    """The JAX functions fail deep inside without ``enc_fn``; the port says
    what is missing."""
    _, cfg, _, tp = converted(WHISPER)
    batch = tb(make_batch(cfg, labels=True))
    with pytest.raises(ValueError, match="enc_fn"):
        tfm.loss_fn(tp, batch, cfg, PCFG)
    with pytest.raises(ValueError, match="encoder"):
        tfm.prefill(tp, batch, cfg, None, 32)


# --------------------------------------------------------------------------
# serving: prefill (with the caches) and decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides", [(LLAVA, {}), (WHISPER, {}),
                                            (WHISPER, dict(enc_seq=37, n_enc_layers=3))],
                         ids=["llava", "whisper", "whisper-enc37-3layers"])
def test_prefill_caches_and_decode_match_jax(arch, overrides):
    """Prefill with the patches (the state's index counts them) or the
    frames (the cross caches of every layer), then 4 decode steps."""
    jcfg, cfg, jv, tp = converted(arch, seed=2, **overrides)
    batch = make_batch(cfg, S=10, seed=3)
    steps, cache = 4, 32
    nxt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, steps))
    jl, js = jtfm.prefill(jv, jb(batch), jcfg, JPCFG, cache, enc_fn=jax_enc(jcfg))
    tl, ts = tfm.prefill(tp, tb(batch), cfg, None, cache, enc_fn=_enc_fn(cfg, PCFG))
    assert ts.index == int(js.index) == 10 + cfg.n_patches
    np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
    assert (ts.cross_kv is None) == (js.cross_kv is None) == (arch == LLAVA)
    for name in ("kv", "cross_kv"):
        t, j = getattr(ts, name), getattr(js, name)
        if t is not None:
            for f in ("k", "v"):
                assert tuple(getattr(t, f).shape) == getattr(j, f).shape
                np.testing.assert_allclose(as_np(getattr(t, f)), as_np(getattr(j, f)),
                                           **MODEL_TOL)
    for t in range(steps):
        jl, js = jtfm.decode_step(jv, jnp.asarray(nxt[:, t:t + 1]), js, jcfg, JPCFG)
        tl, ts = tfm.decode_step(tp, torch.from_numpy(nxt[:, t:t + 1]), ts, cfg, None)
        np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
        assert ts.index == int(js.index)
    np.testing.assert_allclose(as_np(ts.kv.k), as_np(js.kv.k), **MODEL_TOL)


@pytest.mark.parametrize("arch", [LLAVA, WHISPER])
def test_decode_equals_prefill_with_patches_or_frames(arch):
    """Decode steps give the logits of prefilling the longer prompt, after
    the same patches or against the same frames."""
    _, cfg, _, tp = converted(arch, seed=4)
    batch = tb(make_batch(cfg, S=14, seed=6))
    S0, S = 10, 14
    enc_fn = _enc_fn(cfg, PCFG)
    head = {k: v for k, v in batch.items() if k != "tokens"}
    logits, state = tfm.prefill(tp, {**head, "tokens": batch["tokens"][:, :S0]}, cfg, None,
                                32, enc_fn=enc_fn)
    outs = [logits]
    for t in range(S0, S):
        lg, state = tfm.decode_step(tp, batch["tokens"][:, t:t + 1], state, cfg, None)
        outs.append(lg)
    for t, lg in zip(range(S0, S + 1), outs):
        ref, _ = tfm.prefill(tp, {**head, "tokens": batch["tokens"][:, :t]}, cfg, None, 32,
                             enc_fn=enc_fn)
        np.testing.assert_allclose(as_np(lg), as_np(ref), atol=2e-3, rtol=2e-2)


def test_init_decode_state_has_the_cross_caches():
    cfg, jcfg = get_config(WHISPER).reduced(), j_get_config(WHISPER).reduced()
    st = tfm.init_decode_state(cfg, 3, 40, dtype=torch.bfloat16, device="cpu")
    js = jtfm.init_decode_state(jcfg, 3, 40)
    assert tuple(st.cross_kv.k.shape) == js.cross_kv.k.shape == \
        (cfg.num_layers, 3, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    assert st.cross_kv.k.dtype == torch.bfloat16 and not st.cross_kv.k.any()
    assert st.cross_kv.k.data_ptr() != st.cross_kv.v.data_ptr()
    assert tfm.init_decode_state(get_config(LLAVA).reduced(), 1, 8, device="cpu").cross_kv is None


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def test_batch_to_device_keeps_embeddings_float():
    """Token ids and labels become int64; patch embeddings and frames keep
    their values in the parameters' dtype (they were once cast to int64)."""
    cfg = get_config(WHISPER).reduced()
    batch = make_batch(cfg, labels=True)
    out = batch_to_device(batch, torch.device("cpu"), torch.float32)
    assert out["tokens"].dtype == out["labels"].dtype == torch.int64
    assert out["frames"].dtype == torch.float32
    np.testing.assert_array_equal(out["frames"].numpy(), batch["frames"])
    bf = batch_to_device({"patch_embeds": torch.from_numpy(batch["frames"])}, "cpu",
                         torch.bfloat16)
    assert bf["patch_embeds"].dtype == torch.bfloat16 and bf["patch_embeds"].abs().max() > 0


@pytest.mark.parametrize("arch", [LLAVA, WHISPER])
def test_one_train_step_matches_jax(arch):
    """``make_train_step`` (the batch's embeddings through ``batch_to_device``,
    whisper's encoder through ``_enc_fn``) against ``jax.value_and_grad`` of
    the JAX ``loss_fn`` and ``adam_update``: the loss, the gradient norm and
    every parameter after the step.  Adam's first step is sign-like, g / (|g|
    + eps), so a gradient component near zero moves its parameter by up to
    lr x (its rounding difference between the packages) / eps
    (``tests/test_torch_optim.py``): with eps 1e-6 one element of llava's
    ``wo`` lands 1.9e-5 apart, past 1e-4 of the leaf.  eps 1e-4 bounds that
    by lr x 1e-8 / 1e-4 = 3e-7 and leaves every other element's update as
    it was."""
    jcfg, cfg, jv, tp = converted(arch, seed=5)
    kw = dict(lr=3e-3, warmup_steps=0, total_steps=20, eps=1e-4)
    jocfg, ocfg = jopt.OptimConfig(**kw), optim.OptimConfig(**kw)
    batch = make_batch(cfg, labels=True, seed=7)
    (_, jm), jg = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jb(batch), jcfg, JPCFG, enc_fn=jax_enc(jcfg)),
        has_aux=True)(jv)
    jp, _, jom = jopt.adam_update(jv, jg, jopt.init_adam(jv, jocfg), jocfg)
    state = TrainState(tp, optim.init_adam(tp, ocfg))
    state, tm = make_train_step(cfg, PCFG, ocfg)(state, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jom["grad_norm"]), rtol=1e-4)
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jp)))
    got = dict(leaves_with_paths(to_jax_params(state.params, cfg)))
    assert got.keys() == want.keys()
    for path in want:
        rel_close(got[path], want[path], 1e-4, "/".join(path))
