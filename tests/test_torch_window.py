"""The sliding window (mixtral's) on the CPU: ``flash_attention_plain`` and
``flash_attention_bwd_plain`` (the arithmetic of the hand-written CUDA
kernels, which skip the key tiles before a query tile's window and mask the
edge tiles) against the JAX package's ``dense_attention`` /
``chunked_attention`` with ``window=`` (``_block_mask``,
``src/repro/models/attention.py:83-92``) and against ``jax.grad`` of
``chunked_attention``; the autograd wiring of ``ops.attention`` with a window;
and whole windowed models against JAX where the window bites: prefill past the
window (both JAX branches, dense under 512 tokens and chunked above), decode
steps that wrap the rolling cache, loss and every gradient.  The CUDA kernels
themselves run only on the card: ``chip_smoke.py`` holds them against these
plain versions there, at the same ragged windows.

Windows 1, 63, 64, 65, 127, 128, 129 and one longer than the sequence: at and
around the 64 / 128 tiles.  A window of 63 leaves the last rows of a 128-row
q block with nothing to see in the first key block they visit (their scores
there are all -1e30 until their own keys come): the result must not move.

Tolerances: fp32 atol 2e-5 / rtol 2e-4 (the reference's fp32 kernel
tolerance), bf16 atol = rtol = 2e-2 (``tests/test_kernels.py::tol``);
whole-model logits atol 1e-4 / rtol 1e-3 and gradients relative 1e-4, as in
``tests/test_torch_models.py`` and ``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import attention as jatt
from repro.models import modules as jmod
from repro.models import transformer as jtfm
from repro.models.config import ParallelConfig as JParallelConfig

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import modules
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import dense_attention

FP32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
MODEL_TOL = dict(atol=1e-4, rtol=1e-3)
JPCFG = JParallelConfig(remat="none")
WINDOWS = [1, 63, 64, 65, 127, 128, 129, 1000]


def make(B, S, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, hd), np.float32) * 0.5
    k = rng.standard_normal((B, S, Hkv, hd), np.float32) * 0.5
    v = rng.standard_normal((B, S, Hkv, hd), np.float32)
    do = rng.standard_normal((B, S, Hq, hd), np.float32)
    return q, k, v, do


def as_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------
# the kernels' plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_with_window_matches_jax(window, dtype):
    """At the forward kernel's bf16 blocking (128 x 128), GQA 2:1, S 300."""
    q, k, v, _ = make(2, 300, 4, 2, 64, seed=window)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    out = fa.flash_attention_plain(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                   causal=True, window=window)
    assert out.dtype == td
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    np.testing.assert_allclose(as_np(out), as_np(jatt.dense_attention(
        jq, jk, jv, causal=True, window=window)), **tol)
    np.testing.assert_allclose(as_np(out), as_np(jatt.chunked_attention(
        jq, jk, jv, causal=True, window=window, q_chunk=64, k_chunk=32)), **tol)


@pytest.mark.parametrize("block_q,block_k", [(16, 32), (64, 64), (128, 64), (64, 128), (32, 32)])
def test_plain_forward_with_window_independent_of_blocking(block_q, block_k):
    """The kernels' other blockings (fp32 16 x 32, the backward's 64 / 128
    tiles, 32 x 32): the first block visited moves, the result does not."""
    q, k, v, _ = (torch.from_numpy(a) for a in make(1, 333, 4, 2, 64, seed=3))
    for window in (1, 63, 65, 129):
        ref = dense_attention(q, k, v, causal=True, window=window)
        out = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                       block_q=block_q, block_k=block_k)
        np.testing.assert_allclose(as_np(out), as_np(ref), **FP32_TOL)


def test_plain_forward_lse_with_window_is_the_row_logsumexp():
    q, k, v, _ = (torch.from_numpy(a) for a in make(1, 200, 2, 2, 64, seed=4))
    _, lse = fa.flash_attention_plain(q, k, v, causal=True, window=63, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    i = torch.arange(200)
    band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - 63)
    want = torch.logsumexp(s.masked_fill(~band, float("-inf")), -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def jax_window_grads(q, k, v, do, window):
    def f(q, k, v):
        out = jatt.chunked_attention(q, k, v, causal=True, window=window,
                                     q_chunk=64, k_chunk=32)
        return jnp.sum(out * do)
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("shape", [(1, 257, 4, 2, 128), (2, 200, 4, 4, 80)],
                         ids=["257x4x2x128", "200x4x4x80"])
def test_plain_backward_with_window_matches_jax_grad(window, shape):
    """Against ``jax.grad`` of the JAX ``chunked_attention(window=)``, at the
    bf16 kernels' blockings: the dK/dV kernel's 64-row q tiles against 128
    keys, the dQ kernel's 128-row q tiles against 64-key tiles."""
    q, k, v, do = make(*shape, seed=window + 7)
    want = jax_window_grads(q, k, v, do, window)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(qt, kt, vt, window=window, return_lse=True)
    for bq, bk in ((64, 128), (128, 64)):
        got = fa.flash_attention_bwd_plain(qt, kt, vt, out, dot, lse, window=window,
                                           block_q=bq, block_k=bk)
        for g_name, a, b in zip(("dq", "dk", "dv"), got, want):
            b = np.asarray(b)
            if window == 1 and g_name != "dv":
                # a row sees its own key alone: P = 1, dS = 0, the gradient
                # vanishes in exact arithmetic; both sides keep only rounding
                assert np.abs(a.numpy()).max() < 1e-5 and np.abs(b).max() < 1e-5
                continue
            np.testing.assert_allclose(a.numpy(), b, **FP32_TOL, err_msg=g_name)


def test_plain_backward_bf16_with_window_against_the_fp32_oracle():
    q, k, v, do = make(1, 300, 4, 2, 64, seed=9)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(q, k, v, window=65, return_lse=True)
    got = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, window=65)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(dense_attention(*leaves, causal=True, window=65), leaves,
                               do.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        scale = float(b.abs().max())
        np.testing.assert_allclose(as_np(a), as_np(b), atol=2e-2 * scale, rtol=5e-2)


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_ops_attention_carries_the_window_to_the_backward(impl):
    """Under grad ``ops.attention`` goes through ``FlashAttention`` with the
    window in both directions (the plain versions on the CPU, no launch)."""
    q, k, v, do = make(2, 150, 4, 2, 64, seed=10)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    out = ops.attention(*leaves, causal=True, impl=impl, window=40)
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, jax_window_grads(q, k, v, do, 40)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **FP32_TOL)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == before
    # the window is not dropped on the way: without it the gradients differ
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ops.attention(*plain, causal=True, impl=impl).backward(torch.from_numpy(do))
    assert not np.allclose(plain[0].grad.numpy(), leaves[0].grad.numpy(), atol=1e-3)


# --------------------------------------------------------------------------
# windowed models against JAX, where the window bites
# --------------------------------------------------------------------------

def converted(arch, seed=0, **overrides):
    jcfg = j_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jv, _ = jmod.split(jtfm.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, jv, from_jax_params(jax.tree.map(np.asarray, jv), cfg, device="cpu")


@pytest.mark.parametrize("arch,S0,window", [("mixtral-8x7b", 37, None),
                                            ("llama3.2-1b", 45, 20)],
                         ids=["mixtral-8x7b", "llama3.2-1b-window20"])
def test_windowed_prefill_and_rolling_decode_match_jax(arch, S0, window):
    """Prompts past the window (mixtral's reduced window is 16), then decode
    steps that wrap the rolling cache: logits at every step and the cache."""
    over = {} if window is None else {"sliding_window": window}
    jcfg, cfg, jv, tp = converted(arch, seed=1, **over)
    assert 0 < cfg.sliding_window < S0
    B, steps, cache = 2, 6, 64
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S0 + steps))
    jl, js = jtfm.prefill(jv, {"tokens": jnp.asarray(toks[:, :S0])}, jcfg, JPCFG, cache)
    tl, ts = tfm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S0])}, cfg, None, cache)
    assert tuple(ts.kv.k.shape) == js.kv.k.shape and ts.kv.k.shape[2] == cfg.sliding_window
    np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
    np.testing.assert_allclose(as_np(ts.kv.k), as_np(js.kv.k), **MODEL_TOL)
    for t in range(S0, S0 + steps):
        jl, js = jtfm.decode_step(jv, jnp.asarray(toks[:, t:t + 1]), js, jcfg, JPCFG)
        tl, ts = tfm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), ts, cfg, None)
        np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
    np.testing.assert_allclose(as_np(ts.kv.v), as_np(js.kv.v), **MODEL_TOL)


def test_windowed_long_prefill_matches_jax_chunked_branch():
    """S > 512: the JAX side takes chunked_attention with the window, the
    port ops.attention (the plain version on the CPU)."""
    jcfg, cfg, jv, tp = converted("llama3.2-1b", seed=2, sliding_window=100)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 600))
    jl, js = jtfm.prefill(jv, {"tokens": jnp.asarray(toks)}, jcfg, JPCFG, 640)
    tl, ts = tfm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg, None, 640)
    np.testing.assert_allclose(as_np(tl), as_np(jl), **MODEL_TOL)
    np.testing.assert_allclose(as_np(ts.kv.k), as_np(js.kv.k), **MODEL_TOL)


def rel_close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want), 1e-30), what


def test_windowed_moe_loss_and_grads_match_jax():
    """Reduced mixtral at S 40 (window 16): the loss with the router's aux
    term and every gradient against ``jax.grad`` of the JAX ``loss_fn``."""
    jcfg, cfg, jv, tp = converted("mixtral-8x7b", seed=3)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    leaves, spec = modules.tree_flatten(tp)
    live = [p.detach().clone().requires_grad_() for p in leaves]
    total, metrics = tfm.loss_fn(modules.tree_unflatten(spec, live),
                                 {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                                 dataclasses.replace(tfm.ParallelConfig(), remat="none"))
    total.backward()
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, JPCFG),
        has_aux=True)(jv)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5)
    got = jax.tree_util.tree_flatten_with_path(
        to_jax_params(modules.tree_unflatten(spec, [p.grad for p in live]), cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        rel_close(a, b, 1e-4, jax.tree_util.keystr(path))
