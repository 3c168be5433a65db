"""The flash-attention backward on the CPU: ``flash_attention_bwd_plain``
(the arithmetic of the hand-written backward kernel, in tensor ops) against
autograd through the port's ``dense_attention`` and against ``jax.grad`` of
the JAX package's ``chunked_attention`` (``src/repro/models/attention.py:109``),
which is how the JAX model trains; and the autograd wiring of
``ops.attention`` and ``ops.ssd`` (fault F1 of ROADMAP.md).  The SSD scan's
own backward is held to JAX in ``tests/test_torch_ssd_bwd.py``.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against autograd through ``flash_attention_plain`` there.

Tolerances: fp32 atol 2e-5 / rtol 2e-4 (the reference's fp32 kernel
tolerance; the same function, sums in another order); bf16 inputs against the
fp32 oracle atol 2e-2 x the gradient's largest magnitude / rtol 5e-2 (P and
dS rounded to bf16 for the products, the gradients written in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_plain
from repro_torch.models.attention import dense_attention

FP32_TOL = dict(atol=2e-5, rtol=2e-4)

# (B, Sq, Sk, Hq, Hkv, hd): head dims 64 / 80 / 128, GQA 4:1, 2:1 and 1:1,
# ragged lengths against the plain version's 128-row blocks, Sq != Sk
CASES = [(1, 100, 100, 4, 1, 64), (2, 67, 67, 4, 4, 80), (1, 257, 257, 4, 2, 128),
         (1, 150, 45, 2, 1, 64), (2, 40, 130, 4, 2, 80)]


def make(B, Sq, Sk, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd), np.float32) * 0.5
    k = rng.standard_normal((B, Sk, Hkv, hd), np.float32) * 0.5
    v = rng.standard_normal((B, Sk, Hkv, hd), np.float32)
    do = rng.standard_normal((B, Sq, Hq, hd), np.float32)
    return q, k, v, do


def plain_grads(q, k, v, do, causal, dtype=torch.float32, **kw):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True, **kw)
    return fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal, **kw)


def autograd_dense(q, k, v, do, causal):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = dense_attention(*leaves, causal=causal)
    return torch.autograd.grad(out, leaves, torch.from_numpy(do))


def jax_grads(q, k, v, do, causal):
    def f(q, k, v):
        out = jatt.chunked_attention(q, k, v, causal=causal, q_chunk=64, k_chunk=32)
        return jnp.sum(out * do)
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_autograd_through_dense_attention(case, causal):
    q, k, v, do = make(*case)
    for got, want in zip(plain_grads(q, k, v, do, causal), autograd_dense(q, k, v, do, causal)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_jax_grad_of_chunked_attention(case, causal):
    q, k, v, do = make(*case, seed=1)
    for got, want in zip(plain_grads(q, k, v, do, causal), jax_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


# (block_q, block_k, (B, Sq, Sk, Hq, Hkv, hd), causal): three blockings on one
# shape, then the bf16 kernels' own, also held to JAX's gradient: the dK/dV
# kernel walks 64-row q tiles against 128 keys, the dQ kernel 128-row q tiles
# against 64-key tiles; ragged Sq 333 / Sk 257 (and the other way round),
# causal and not, hd 64 and 128, GQA 2:1 and 4:1
BLOCK_CASES = [(16, 16, (1, 130, 130, 4, 2, 64), True), (64, 32, (1, 130, 130, 4, 2, 64), True),
               (128, 128, (1, 130, 130, 4, 2, 64), True),
               (64, 128, (1, 333, 257, 4, 2, 64), True), (128, 64, (1, 333, 257, 4, 2, 64), True),
               (64, 128, (1, 333, 257, 4, 2, 128), False),
               (128, 64, (1, 257, 333, 4, 2, 128), False),
               (64, 128, (2, 200, 200, 8, 2, 64), True), (128, 64, (2, 200, 200, 8, 2, 64), False)]


@pytest.mark.parametrize("block", BLOCK_CASES)
def test_bwd_plain_independent_of_block_size(block):
    block_q, block_k, shape, causal = block
    q, k, v, do = make(*shape, seed=2)
    ref = plain_grads(q, k, v, do, causal)
    got = plain_grads(q, k, v, do, causal, block_q=block_q, block_k=block_k)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FP32_TOL)
    if shape[1] != 130:                               # the kernels' blockings
        for a, b in zip(got, jax_grads(q, k, v, do, causal)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_bf16_against_the_fp32_oracle(causal):
    q, k, v, do = make(1, 200, 200, 4, 2, 64, seed=3)
    # the same bf16 values on both sides
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (q, k, v, do))
    got = plain_grads(q, k, v, do, causal, dtype=torch.bfloat16)
    for a, b in zip(got, autograd_dense(q, k, v, do, causal)):
        assert a.dtype == torch.bfloat16
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=2e-2 * scale, rtol=5e-2)


def test_plain_forward_lse_is_the_row_logsumexp():
    q, k, v, _ = make(2, 70, 90, 4, 2, 64, seed=4)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = fa.flash_attention_plain(qt, kt, vt, causal=True, return_lse=True)
    assert torch.equal(out, fa.flash_attention_plain(qt, kt, vt, causal=True))
    kr = kt.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kr) / 8.0
    s = s.masked_fill(torch.arange(90)[None] > torch.arange(70)[:, None], float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-5,
                               rtol=1e-5)


# --------------------------------------------------------------------------
# autograd wiring (fault F1): attention and the SSD scan differentiate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_ops_attention_under_grad_goes_through_the_function(impl):
    q, k, v, do = make(2, 50, 50, 4, 2, 64, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    out = ops.attention(*leaves, causal=True, impl=impl)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    want = autograd_dense(q, k, v, do, True)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.abs().max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), w.numpy(), **FP32_TOL)
    # a CPU tensor takes the plain versions: no kernel launched
    assert fa.flash_attention.launches == fa.flash_attention_bwd.launches == 0


def test_ops_attention_without_grad_runs_the_forward_alone():
    q, k, v, _ = make(1, 40, 40, 2, 2, 64, seed=6)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.no_grad():
        out = ops.attention(qt, kt, vt)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(qt.detach(), kt.detach(), vt.detach()))


def test_the_backward_kernel_wrapper_takes_cuda_tensors_only():
    q, k, v, do = (torch.from_numpy(a) for a in make(1, 64, 64, 2, 2, 64))
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_bwd(q, k, v, out, do, lse)


def test_ops_attention_kernel_route_on_cpu_raises_under_grad_too():
    q, k, v, _ = make(1, 32, 32, 2, 2, 64)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.attention(*leaves, impl="kernel")


def _ssd_inputs(requires_grad):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 40, 2, 16), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((1, 40, 2),
                                                                           np.float32)))
    A = -torch.ones(2)
    Bm = torch.from_numpy(rng.standard_normal((1, 40, 1, 8), np.float32))
    Cm = torch.from_numpy(rng.standard_normal((1, 40, 1, 8), np.float32))
    x.requires_grad_(requires_grad)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("impl", ["auto", "plain", "kernel"])
def test_ops_ssd_refuses_to_run_under_grad(impl):
    """The name is historical (kept so that the test's ID stays): the test
    pinned the scan's refusal under grad, and is turned now that it has a
    backward.  On a CPU tensor ``auto`` and ``plain`` go through
    ``SSDScan`` (plain forward, ``ssd_scan_bwd_plain``) and give the
    gradients of autograd through ``ssd_scan_plain`` (fp32, FP32_TOL), with
    no kernel launched; ``kernel`` raises, naming CUDA, as the attention's
    kernel route does."""
    args = _ssd_inputs(True)
    leaves = [args[0], args[1].requires_grad_(), args[2].requires_grad_(),
              args[3].requires_grad_(), args[4].requires_grad_()]
    if impl == "kernel":
        with pytest.raises(ValueError, match="CUDA"):
            ops.ssd(*leaves, impl=impl)
        return
    ssd_scan.launches = ssd_scan_bwd.launches = 0
    y = ops.ssd(*leaves, impl=impl)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal(tuple(y.shape), np.float32))
    got = torch.autograd.grad(y, leaves, dy)
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(ssd_scan_plain(*ref), ref, dy)
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), **FP32_TOL)
    assert ssd_scan.launches == ssd_scan_bwd.launches == 0


def test_ops_ssd_runs_without_grad():
    args = _ssd_inputs(True)
    with torch.no_grad():
        y = ops.ssd(*args)
    assert y.shape == args[0].shape
    y2 = ops.ssd(*_ssd_inputs(False))          # nothing requires a gradient
    assert torch.equal(y, y2)
