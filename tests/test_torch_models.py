"""The port's model code on the CPU, function by function against the JAX
package on the same numpy inputs and (converted) weights.

Tolerances, fp32 on both sides unless a test says otherwise:

* single functions: atol 1e-5 / rtol 1e-5 — the same arithmetic, libm and
  summation order differ in the last bits;
* whole-model logits: atol 1e-4 / rtol 1e-3 — two layers of products whose
  sums are taken in another order (measured differences are near 3e-7);
* decode-equals-prefill inside the port: the reference's atol 2e-3 /
  rtol 2e-2 (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models import modules as jmod
from repro.models import transformer as jtfm
from repro.models import whisper as jwhisper
from repro.models.config import ParallelConfig as JParallelConfig

from repro_torch.configs.registry import (ARCH_IDS, PORTED_ARCH_IDS,
                                          all_configs, get_config)
from repro_torch.convert import from_jax_params
from repro_torch.models import attention as att
from repro_torch.models import layers, modules, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.parallel.steps import _enc_fn

FN_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-3)
JPCFG = JParallelConfig(remat="none")


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def J(a, dtype=None):
    x = jnp.asarray(a)
    return x if dtype is None else x.astype(dtype)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_config_copy_equals_jax_config(arch):
    """The port's own copy of each configuration holds the same figures."""
    for reduce in (False, True):
        a, b = get_config(arch), j_get_config(arch)
        if reduce:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.padded_vocab, a.d_qkv, a.d_kv) == \
            (b.padded_vocab, b.d_qkv, b.d_kv)


def test_registry_says_what_is_not_ported():
    """The name is historical (kept so that the test's ID stays): every id
    of the JAX package is ported now, llava-next-34b (vlm) and
    whisper-medium (audio) last; an unknown id still raises."""
    assert set(all_configs()) == set(PORTED_ARCH_IDS) == set(ARCH_IDS)
    assert len(PORTED_ARCH_IDS) == len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-17")


def test_other_families_raise_not_implemented():
    """The name is historical (kept so that the test's ID stays): the test
    pinned the refusal of the families still to come.  Now the MoE family
    initialises (an expert FFN in every block) and runs a forward, the vlm
    family initialises its patch projection and runs one over a patch
    prefix, a block with cross-attention initialises and runs, and an
    unknown family still raises."""
    moe = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              family="moe", n_experts=4, top_k=2)
    vlm = dataclasses.replace(get_config("llama3.2-1b").reduced(), family="vlm",
                              n_patches=3)
    pv = tfm.init(0, vlm, device="cpu")
    assert tuple(pv["mm_proj"].shape) == (vlm.d_model, vlm.d_model)
    lg, st = tfm.prefill(pv, {"tokens": torch.arange(5)[None],
                              "patch_embeds": torch.randn(1, 3, vlm.d_model) * 0.02},
                         vlm, None, 16)
    assert st.index == 8 and bool(torch.isfinite(lg).all())
    assert tfm.init_decode_state(vlm, 1, 8, device="cpu").cross_kv is None
    with pytest.raises(NotImplementedError, match="unknown model family"):
        tfm.init(0, dataclasses.replace(vlm, family="diffusion"), device="cpu")
    blk = layers.init_attn_block(torch.Generator(), moe, device="cpu", with_cross=True)
    assert {"ln_x", "cross"} <= set(blk)
    x = torch.randn(1, 4, moe.d_model)
    y, _, new_cross, _ = layers.apply_attn_block(
        blk, moe, None, x, positions=torch.arange(4)[None], mode="prefill", cache_len=8,
        enc_out=torch.randn(1, 7, moe.d_model))
    assert tuple(new_cross.k.shape) == (1, 7, moe.n_kv_heads, moe.head_dim)
    assert bool(torch.isfinite(y).all())
    p = tfm.init(0, moe, device="cpu")
    assert set(p["blocks"][0]["ffn"]) == {"router", "w_gate", "w_up", "w_down"}
    assert tuple(p["blocks"][0]["ffn"]["w_gate"].shape) == (4, moe.d_model, moe.d_ff)
    blk = layers.init_attn_block(torch.Generator(), moe, device="cpu", ffn="moe")
    assert "router" in blk["ffn"]
    logits, st = tfm.prefill(p, {"tokens": torch.arange(6)[None] % moe.vocab_size},
                             moe, None, 8)
    assert tuple(logits.shape) == (1, moe.padded_vocab) and st.index == 6
    assert bool(torch.isfinite(logits).all())


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x, g = rnd((2, 5, 64), 0, 3.0), rnd((64,), 1) + 1.0
    out = modules.rms_norm(T(x, td), T(g, td), 1e-5)
    ref = jmod.rms_norm(J(x, jd), J(g, jd), 1e-5)
    assert out.dtype == td
    tol = FN_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_and_gelu_match_jax(dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    a, b = rnd((3, 7, 32), 2, 2.0), rnd((3, 7, 32), 3)
    tol = FN_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(
        as_np(modules.swiglu(T(a, td), T(b, td))),
        as_np(jmod.swiglu(J(a, jd), J(b, jd))), **tol)
    np.testing.assert_allclose(as_np(modules.gelu(T(a, td))),
                               as_np(jmod.gelu(J(a, jd))), **tol)


def test_initialisers_follow_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = modules.dense_init(gen, (256, 512), device="cpu")
    std = 1.0 / np.sqrt(256)
    assert float(w.abs().max()) <= 2.0 * std + 1e-6          # truncated at 2 sigma
    # a unit normal truncated at +-2 has standard deviation 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.02
    w3 = modules.dense_init(gen, (8, 16, 32), device="cpu")  # fan-in 8*16
    assert float(w3.abs().max()) <= 2.0 / np.sqrt(128) + 1e-6
    ws = modules.dense_init(gen, (64, 64), scale=0.5, device="cpu",
                            dtype=torch.bfloat16)
    assert ws.dtype == torch.bfloat16 and float(ws.float().abs().max()) <= 1.0
    e = modules.embed_init(gen, 4096, 64, device="cpu")
    assert abs(float(e.std()) - 0.02) < 1e-3
    # same seed, same numbers; the global generator is not touched
    state = torch.get_rng_state()
    a = modules.dense_init(torch.Generator().manual_seed(5), (16, 16), device="cpu")
    b = modules.dense_init(torch.Generator().manual_seed(5), (16, 16), device="cpu")
    assert torch.equal(a, b) and torch.equal(state, torch.get_rng_state())


def test_init_has_the_reference_parameter_names_and_shapes():
    for arch in PORTED_ARCH_IDS:
        cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
        p = tfm.init(0, cfg, device="cpu")
        jv, _ = jmod.split(jtfm.init(jax.random.PRNGKey(0), jcfg))
        assert set(p) == set(jv)
        assert p["embed"].shape == jv["embed"].shape
        assert len(p["blocks"]) == cfg.num_layers
        flat_j = {jax.tree_util.keystr(k): v.shape[1:] for k, v in
                  jax.tree_util.tree_flatten_with_path(jv["blocks"])[0]}
        # every level, however deep (arctic: ['ffn']['dense']['w_gate'])
        flat_t = {}

        def walk(tree, path):
            for name, sub in tree.items():
                if isinstance(sub, dict):
                    walk(sub, f"{path}['{name}']")
                else:
                    flat_t[f"{path}['{name}']"] = tuple(sub.shape)
        walk(p["blocks"][0], "")
        assert flat_t == flat_j
        if cfg.family == "hybrid":         # one unstacked shared block
            assert {k: tuple(w.shape) for k, w in p["shared_attn"]["attn"].items()} == \
                {k: w.shape for k, w in jv["shared_attn"]["attn"].items()}
        if cfg.family == "vlm":
            assert tuple(p["mm_proj"].shape) == jv["mm_proj"].shape
        if cfg.family == "audio":          # the encoder: its own stack and norm
            enc_j = {jax.tree_util.keystr(k): v.shape[1:] for k, v in
                     jax.tree_util.tree_flatten_with_path(jv["encoder"]["blocks"])[0]}
            flat_t.clear()
            walk(p["encoder"]["blocks"][0], "")
            assert flat_t == enc_j
            assert len(p["encoder"]["blocks"]) == cfg.n_enc_layers
            assert tuple(p["encoder"]["final_norm"].shape) == \
                jv["encoder"]["final_norm"].shape


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["default", "2d", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(mode, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rnd((2, 9, 3, 16), 4)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    out = att.apply_rope(T(x, td), T(pos), 10000.0, mode)
    ref = jatt.apply_rope(J(x, jd), J(pos), 10000.0, mode)
    assert out.dtype == td
    tol = FN_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol)


def test_repeat_kv_matches_jax():
    k = rnd((2, 5, 2, 4), 5)
    np.testing.assert_array_equal(as_np(att.repeat_kv(T(k), 3)),
                                  as_np(jatt.repeat_kv(J(k), 3)))
    assert att.repeat_kv(T(k), 1).shape == (2, 5, 2, 4)


ATT_CASES = [
    dict(causal=True), dict(causal=False), dict(causal=True, window=17),
    dict(causal=False, window=5), dict(causal=True, q_offset=30, kv_len=80),
    dict(causal=True, window=11, q_offset=7), dict(causal=False, kv_len=33),
]


@pytest.mark.parametrize("kw", ATT_CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_dense_and_chunked_attention_match_jax(kw):
    B, Sq, Sk, Hq, Hkv, hd = 2, 50, 100, 4, 2, 16
    q, k, v = rnd((B, Sq, Hq, hd), 6, 0.5), rnd((B, Sk, Hkv, hd), 7, 0.5), \
        rnd((B, Sk, Hkv, hd), 8)
    ref = jatt.dense_attention(J(q), J(k), J(v), **kw)
    np.testing.assert_allclose(
        as_np(att.dense_attention(T(q), T(k), T(v), **kw)), as_np(ref), **FN_TOL)
    refc = jatt.chunked_attention(J(q), J(k), J(v), q_chunk=32, k_chunk=16, **kw)
    outc = att.chunked_attention(T(q), T(k), T(v), q_chunk=32, k_chunk=16, **kw)
    np.testing.assert_allclose(as_np(outc), as_np(refc), **FN_TOL)
    np.testing.assert_allclose(as_np(outc), as_np(ref), **FN_TOL)


def test_chunked_attention_bf16_matches_jax():
    q, k, v = rnd((1, 70, 4, 16), 9, 0.5), rnd((1, 70, 4, 16), 10, 0.5), \
        rnd((1, 70, 4, 16), 11)
    b = torch.bfloat16
    out = att.chunked_attention(T(q, b), T(k, b), T(v, b), q_chunk=32, k_chunk=32)
    ref = jatt.chunked_attention(J(q, jnp.bfloat16), J(k, jnp.bfloat16),
                                 J(v, jnp.bfloat16), q_chunk=32, k_chunk=32)
    assert out.dtype == b
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(window, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    B, S, Hq, Hkv, hd = 3, 24, 4, 2, 16
    q, kc, vc = rnd((B, 1, Hq, hd), 12, 0.5), rnd((B, S, Hkv, hd), 13, 0.5), \
        rnd((B, S, Hkv, hd), 14)
    lens = np.array([24, 9, 1], np.int32)
    out = att.decode_attention(T(q, td), T(kc, td), T(vc, td), T(lens),
                               window=window)
    ref = jatt.decode_attention(J(q, jd), J(kc, jd), J(vc, jd), J(lens),
                                window=window)
    tol = FN_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol)
    # a host integer works as the length of every row
    out_i = att.decode_attention(T(q, td), T(kc, td), T(vc, td), 9, window=window)
    ref_i = jatt.decode_attention(J(q, jd), J(kc, jd), J(vc, jd),
                                  jnp.full((B,), 9), window=window)
    np.testing.assert_allclose(as_np(out_i), as_np(ref_i), **tol)


# --------------------------------------------------------------------------
# layers: the KV cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,cache_len,window", [
    (10, 16, 0), (16, 16, 0), (20, 16, 0),          # pad / exact / keep the tail
    (5, 32, 8), (8, 32, 8), (21, 32, 8), (21, 6, 8),  # rolling window buffers
])
def test_build_cache_matches_jax(S, cache_len, window):
    k, v = rnd((2, S, 2, 4), 15), rnd((2, S, 2, 4), 16)
    out = layers._build_cache(T(k), T(v), cache_len, window)
    ref = jlayers._build_cache(J(k), J(v), cache_len, window)
    np.testing.assert_array_equal(as_np(out.k), as_np(ref.k))
    np.testing.assert_array_equal(as_np(out.v), as_np(ref.v))


@pytest.mark.parametrize("pos", [0, 3, 7, 11])
def test_write_cache_matches_jax_and_writes_in_place(pos):
    buf, kv = rnd((2, 8, 2, 4), 17), rnd((2, 1, 2, 4), 18)
    tb = T(buf.copy())
    out = layers._write_cache(tb, T(kv), pos)
    ref = jlayers._write_cache(J(buf), J(kv), pos)   # clamps pos like the port
    np.testing.assert_array_equal(as_np(out), as_np(ref))
    assert out.data_ptr() == tb.data_ptr()           # the same buffer


def test_rolling_window_decode_matches_jax():
    """A sliding-window layer: the prefilled tail lies in rolling slots, then
    decode steps write at index % window.  Attention block against JAX.  The
    windowed prefill (which once raised here) runs through ``ops.attention``
    and gives JAX's outputs and rolling cache; ``_build_cache`` laid from the
    unrolled keys and values gives the same buffer."""
    jcfg = j_get_config("llama3.2-1b").reduced(sliding_window=8)
    cfg = get_config("llama3.2-1b").reduced(sliding_window=8)
    jp, _ = jmod.split(jlayers.init_attn_block(jax.random.PRNGKey(1), jcfg))
    tp = from_jax_params({"embed": np.zeros((1, 1), np.float32),
                          "final_norm": np.zeros(1, np.float32),
                          "blocks": jax.tree.map(lambda a: np.asarray(a)[None], jp)},
                         dataclasses.replace(cfg, num_layers=1),
                         device="cpu")["blocks"][0]
    B, S0, steps = 2, 13, 6
    x = rnd((B, S0 + steps, cfg.d_model), 19)
    pos = np.broadcast_to(np.arange(S0 + steps, dtype=np.int32), (B, S0 + steps))
    jy, jc, _, _ = jlayers.apply_attn_block(
        jp, jcfg, JPCFG, J(x[:, :S0]), positions=J(pos[:, :S0]), mode="prefill",
        cache_len=32)
    ty, tpc, tcross, taux = layers.apply_attn_block(
        tp, cfg, None, T(x[:, :S0]), positions=T(pos[:, :S0]), mode="prefill",
        cache_len=32)
    assert tcross is None and float(taux) == 0.0
    np.testing.assert_allclose(as_np(ty), as_np(jy), **MODEL_TOL)
    np.testing.assert_allclose(as_np(tpc.k), as_np(jc.k), **FN_TOL)
    np.testing.assert_allclose(as_np(tpc.v), as_np(jc.v), **FN_TOL)
    # the same keys and values, unrolled: the JAX prefill without a window
    _, jfull, _, _ = jlayers.apply_attn_block(
        jp, dataclasses.replace(jcfg, sliding_window=0), JPCFG, J(x[:, :S0]),
        positions=J(pos[:, :S0]), mode="prefill", cache_len=S0)
    tc = layers._build_cache(T(np.array(jfull.k)), T(np.array(jfull.v)), 32, 8)
    assert tc.k.shape == (B, 8, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(as_np(tc.k), as_np(jc.k), **FN_TOL)
    for t in range(S0, S0 + steps):
        jy, jc, _, _ = jlayers.apply_attn_block(
            jp, jcfg, JPCFG, J(x[:, t:t + 1]), positions=J(pos[:, t:t + 1]),
            mode="decode", cache=jc, cache_index=jnp.asarray(t, jnp.int32))
        ty, tc, _, _ = layers.apply_attn_block(
            tp, cfg, None, T(x[:, t:t + 1]), positions=T(pos[:, t:t + 1]),
            mode="decode", cache=tc, cache_index=t)
        np.testing.assert_allclose(as_np(ty), as_np(jy), **MODEL_TOL)
        np.testing.assert_allclose(as_np(tc.k), as_np(jc.k), **FN_TOL)
        np.testing.assert_allclose(as_np(tc.v), as_np(jc.v), **FN_TOL)


# --------------------------------------------------------------------------
# whole model on converted weights
# --------------------------------------------------------------------------

def converted(arch, seed=0, **overrides):
    jcfg = j_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jv, _ = jmod.split(jtfm.init(jax.random.PRNGKey(seed), jcfg))
    if cfg.qkv_bias:    # the reference initialises biases to zero: make them count
        for i, name in enumerate(("bq", "bk", "bv")):
            b = jv["blocks"]["attn"][name]
            jv["blocks"]["attn"][name] = jnp.asarray(rnd(b.shape, 40 + i, 0.1))
    if cfg.qk_norm:
        for i, name in enumerate(("q_norm", "k_norm")):
            g = jv["blocks"]["attn"][name]
            jv["blocks"]["attn"][name] = jnp.asarray(1.0 + rnd(g.shape, 50 + i, 0.1))
    if cfg.family in ("ssm", "hybrid"):   # the conv bias is initialised to zero too
        b = jv["blocks"]["ssm"]["conv_b"]
        jv["blocks"]["ssm"]["conv_b"] = jnp.asarray(rnd(b.shape, 60, 0.1))
    tp = from_jax_params(jax.tree.map(np.asarray, jv), cfg, device="cpu")
    return jcfg, cfg, jv, tp


def frames_for(cfg, B, seed=7):
    """whisper's encoder frames as ``tests/test_models.py`` draws them (0.02
    N(0, 1)), as a batch entry for both packages, and each package's
    ``enc_fn``; nothing for the other families."""
    if cfg.family != "audio":
        return {}, {}, None, None
    fr = rnd((B, cfg.enc_seq, cfg.d_model), seed, 0.02)
    jcfg = j_get_config(cfg.name).reduced()
    return ({"frames": J(fr)}, {"frames": T(fr)},
            lambda p, b: jwhisper.encode(p, b, jcfg, JPCFG), _enc_fn(cfg, ParallelConfig()))


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Text prompts (llava without patches is a text LM, in both packages);
    whisper's prompts run against encoded frames, its cross caches held
    too."""
    jcfg, cfg, jv, tp = converted(arch)
    B, S0, steps, cache = 2, 16, 4, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S0 + steps))
    jfr, tfr, jenc, tenc = frames_for(cfg, B)
    jl, js = jtfm.prefill(jv, {"tokens": J(toks[:, :S0]), **jfr}, jcfg, JPCFG, cache,
                          enc_fn=jenc)
    tl, ts = tfm.prefill(tp, {"tokens": T(toks[:, :S0]), **tfr}, cfg, ParallelConfig(),
                         cache, enc_fn=tenc)
    assert tuple(tl.shape) == (B, cfg.padded_vocab) and ts.index == S0
    np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
    assert_state_close(ts, js)
    for t in range(S0, S0 + steps):
        jl, js = jtfm.decode_step(jv, J(toks[:, t:t + 1]), js, jcfg, JPCFG)
        tl, ts = tfm.decode_step(tp, T(toks[:, t:t + 1]), ts, cfg, None)
        np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
        assert ts.index == int(js.index)
    assert_state_close(ts, js)


def assert_state_close(ts, js):
    """Every buffer of the decode state that the family has: the KV cache,
    the SSM states and conv lags, the hybrid's shared-block caches, the
    audio decoder's cross caches."""
    for name, fields in (("kv", "kv"), ("ssm", "h conv"), ("shared_kv", "kv"),
                         ("cross_kv", "kv")):
        t, j = getattr(ts, name), getattr(js, name)
        assert (t is None) == (j is None), name
        if t is not None:
            for f in fields.split() if fields != "kv" else ("k", "v"):
                assert tuple(getattr(t, f).shape) == getattr(j, f).shape
                np.testing.assert_allclose(as_np(getattr(t, f)), as_np(getattr(j, f)),
                                           **MODEL_TOL)


def test_long_prefill_matches_jax_chunked_branch():
    """S > 512: the JAX side takes chunked_attention, the port ops.attention."""
    jcfg, cfg, jv, tp = converted("llama3.2-1b", seed=2)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 600))
    jl, js = jtfm.prefill(jv, {"tokens": J(toks)}, jcfg, JPCFG, 640)
    tl, ts = tfm.prefill(tp, {"tokens": T(toks)}, cfg, None, 640)
    np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
    np.testing.assert_allclose(as_np(ts.kv.k), as_np(js.kv.k), **MODEL_TOL)


def count_drops(monkeypatch):
    """Record the choices each MoE dispatch drops past capacity."""
    drops = []
    dispatch = moe._dispatch_indices

    def counted(expert_idx, n_experts, capacity):
        slot = dispatch(expert_idx, n_experts, capacity)
        drops.append(int((slot < 0).sum()))
        return slot
    monkeypatch.setattr(moe, "_dispatch_indices", counted)
    return drops


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_decode_equals_prefill_inside_the_port(arch, monkeypatch):
    """Decode steps give the logits of prefilling the longer prompt.  For the
    MoE family this holds where nothing drops, as in the reference
    (``tests/test_models.py::test_arch_decode_matches_prefill`` raises the
    capacity factor for it): a prefill routes the whole prompt as one group
    and drops choices past an expert's capacity, a decode step routes one
    token, which never drops.  At the configurations' capacity factor 1.25
    the reduced arctic and mixtral do drop on these prompts (asserted, and
    counted in the message), so the comparison runs at capacity factor E / k,
    where a bucket holds every token of a group and nothing drops (asserted)."""
    _, cfg, _, tp = converted(arch, seed=3)
    B, S, S0, cache = 2, 20, 16, 32
    toks = T(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    _, fr, _, enc = frames_for(cfg, B)      # whisper: the same frames throughout
    drops = count_drops(monkeypatch)
    if cfg.n_experts:
        tfm.prefill(tp, {"tokens": toks}, cfg, None, cache)
        assert sum(drops) > 0, f"{arch}: no choice dropped at capacity factor 1.25"
        dropped_at_default = list(drops)
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        drops.clear()
    logits, state = tfm.prefill(tp, {"tokens": toks[:, :S0], **fr}, cfg, None, cache,
                                enc_fn=enc)
    outs = [logits]
    for t in range(S0, S):
        lg, state = tfm.decode_step(tp, toks[:, t:t + 1], state, cfg, None)
        outs.append(lg)
    for t, lg in zip(range(S0, S + 1), outs):
        ref, _ = tfm.prefill(tp, {"tokens": toks[:, :t], **fr}, cfg, None, cache,
                             enc_fn=enc)
        np.testing.assert_allclose(as_np(lg), as_np(ref), atol=2e-3, rtol=2e-2)
    assert sum(drops) == 0, drops
    if cfg.n_experts:
        assert len(drops) == cfg.num_layers * (2 * (S - S0) + 2), drops
        print(f"{arch}: choices dropped per layer at capacity factor 1.25: "
              f"{dropped_at_default}")


def test_init_decode_state_matches_jax_layout():
    cfg, jcfg = get_config("llama3.2-1b").reduced(), j_get_config("llama3.2-1b").reduced()
    st = tfm.init_decode_state(cfg, 3, 40, dtype=torch.bfloat16, device="cpu")
    js = jtfm.init_decode_state(jcfg, 3, 40)
    assert tuple(st.kv.k.shape) == js.kv.k.shape == (2, 3, 40, 2, 16)
    assert st.kv.k.dtype == torch.bfloat16 and st.index == 0
    assert st.ssm is None and st.shared_kv is None and st.cross_kv is None
    swa = get_config("llama3.2-1b").reduced(sliding_window=8)
    assert tfm.init_decode_state(swa, 1, 40, device="cpu").kv.k.shape[2] == 8


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_init_decode_state_matches_jax_layout_for_ssm_families(arch):
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    st = tfm.init_decode_state(cfg, 3, 40, dtype=torch.bfloat16, device="cpu")
    js = jtfm.init_decode_state(jcfg, 3, 40)
    assert st.kv is None and js.kv is None and st.index == 0
    assert tuple(st.ssm.h.shape) == js.ssm.h.shape
    assert tuple(st.ssm.conv.shape) == js.ssm.conv.shape
    assert st.ssm.h.dtype == torch.float32 and st.ssm.conv.dtype == torch.bfloat16
    assert not st.ssm.h.any() and not st.ssm.conv.any()
    if cfg.family == "hybrid":
        assert tuple(st.shared_kv.k.shape) == js.shared_kv.k.shape == \
            (cfg.num_layers // cfg.attn_every, 3, 40, cfg.n_kv_heads, cfg.head_dim)
        assert st.shared_kv.k.data_ptr() != st.shared_kv.v.data_ptr()
    else:
        assert st.shared_kv is None and js.shared_kv is None


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_decode_writes_the_ssm_state_in_place(arch):
    _, cfg, _, tp = converted(arch, seed=4)
    toks = T(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9)))
    _, st = tfm.prefill(tp, {"tokens": toks[:, :8]}, cfg, None, 16)
    h, conv = st.ssm.h.clone(), st.ssm.conv.clone()
    ptrs = (st.ssm.h.data_ptr(), st.ssm.conv.data_ptr())
    _, st2 = tfm.decode_step(tp, toks[:, 8:], st, cfg, None)
    assert (st2.ssm.h.data_ptr(), st2.ssm.conv.data_ptr()) == ptrs
    assert not torch.equal(st2.ssm.h, h) and not torch.equal(st2.ssm.conv, conv)
    assert st2.index == 9


def test_hybrid_needs_whole_groups_of_layers():
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(), num_layers=3)
    with pytest.raises(ValueError, match="attn_every"):
        tfm.init(0, cfg, device="cpu")


def test_untied_head_is_used_when_embeddings_are_not_tied():
    cfg = get_config("qwen3-32b").reduced()
    assert not cfg.tie_embeddings
    p = tfm.init(1, cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    a, _ = tfm.prefill(p, {"tokens": toks}, cfg, None, 8)
    p["lm_head"] = p["lm_head"] * 2
    b, _ = tfm.prefill(p, {"tokens": toks}, cfg, None, 8)
    np.testing.assert_allclose(as_np(b), 2 * as_np(a), rtol=1e-5, atol=1e-6)


def test_from_jax_params_rejects_what_it_cannot_convert():
    """``mm_proj`` stays unexpected on a dense configuration.  The audio
    case once pinned the converter's refusal of the family; now the family
    converts, and a tree without its encoder is refused as such."""
    _, cfg, jv, _ = converted("llama3.2-1b")
    vals = jax.tree.map(np.asarray, jv)
    with pytest.raises(ValueError, match="stacked"):
        from_jax_params(vals, dataclasses.replace(cfg, num_layers=3), device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_params({**vals, "mm_proj": np.zeros((2, 2))}, cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        from_jax_params(vals, dataclasses.replace(cfg, family="audio"), device="cpu")
    bf = from_jax_params(vals, cfg, device="cpu", dtype=torch.bfloat16)
    assert bf["blocks"][1]["attn"]["wq"].dtype == torch.bfloat16
    assert isinstance(cfg, ModelConfig)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_from_jax_params_converts_ssm_and_hybrid_trees(arch):
    """Mamba2 blocks are {ln, ssm}; the depth check reads them, and the
    hybrid's shared block is one unstacked attention block."""
    _, cfg, jv, tp = converted(arch)
    vals = jax.tree.map(np.asarray, jv)
    assert len(tp["blocks"]) == cfg.num_layers
    assert set(tp["blocks"][0]) == {"ln", "ssm"}
    np.testing.assert_array_equal(as_np(tp["blocks"][1]["ssm"]["conv_w"]),
                                  vals["blocks"]["ssm"]["conv_w"][1])
    with pytest.raises(ValueError, match="stacked"):
        from_jax_params(vals, dataclasses.replace(cfg, num_layers=cfg.num_layers + 2),
                        device="cpu")
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(as_np(tp["shared_attn"]["attn"]["wq"]),
                                      vals["shared_attn"]["attn"]["wq"])
    else:
        with pytest.raises(ValueError, match="unexpected"):
            from_jax_params({**vals, "shared_attn": {}}, cfg, device="cpu")
