"""The port's kernel layer on the CPU, held against the JAX package.

``flash_attention_plain`` (the plain PyTorch version that sits beside the
CUDA kernel and repeats its arithmetic) against the Pallas kernel in
interpret mode and against ``dense_attention``, on the same numpy inputs;
``ops.attention`` against the JAX ``ops.attention``.  The CUDA kernel itself
cannot run here: ``chip_smoke.py`` holds it against the plain version on the
card.

Tolerances are the reference's own (``tests/test_kernels.py::tol``): fp32
atol 2e-5 / rtol 2e-4 (sums in another order), bf16 atol = rtol = 2e-2 (one
bf16 rounding of the output, and of ``p`` before the second product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.attention import dense_attention as j_dense

from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models.attention import dense_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-4)


def make_qkv(B, Sq, Sk, Hq, Hkv, hd, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd), np.float32) * 0.5
    k = rng.standard_normal((B, Sk, Hkv, hd), np.float32) * 0.5
    v = rng.standard_normal((B, Sk, Hkv, hd), np.float32)
    return q, k, v


def to_jax(arrs, dtype):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrs)


def to_torch(arrs, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrs)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# the reference's sweep plus one Sq != Sk case: (B, Sq, Sk, H, hd)
SWEEP = [(1, 64, 64, 1, 64), (2, 128, 128, 4, 64), (1, 200, 200, 2, 80),
         (2, 96, 96, 8, 128), (2, 72, 200, 2, 64)]


@pytest.mark.parametrize("B,Sq,Sk,H,hd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret(B, Sq, Sk, H, hd, dtype, causal):
    arrs = make_qkv(B, Sq, Sk, H, H, hd)
    jd, td = DTYPES[dtype]
    ref = j_flash(*to_jax(arrs, jd), causal=causal, block_q=64, block_k=64,
                  interpret=True)
    out = flash_attention_plain(*to_torch(arrs, td), causal=causal,
                                block_q=64, block_k=64)
    assert out.dtype == td and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


@pytest.mark.parametrize("B,Sq,Sk,H,hd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_dense(B, Sq, Sk, H, hd, dtype, causal):
    arrs = make_qkv(B, Sq, Sk, H, H, hd)
    jd, td = DTYPES[dtype]
    ref = j_dense(*to_jax(arrs, jd), causal=causal)
    out = flash_attention_plain(*to_torch(arrs, td), causal=causal)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))
    # and the port's own oracle agrees with both
    own = dense_attention(*to_torch(arrs, td), causal=causal)
    np.testing.assert_allclose(as_np(own), as_np(ref), **tol(dtype))


@pytest.mark.parametrize("block", [16, 64, 128])
def test_flash_plain_independent_of_block_size(block):
    q, k, v = to_torch(make_qkv(2, 100, 100, 3, 3, 64), torch.float32)
    ref = flash_attention_plain(q, k, v, causal=True, block_q=1000,
                                block_k=1000)
    out = flash_attention_plain(q, k, v, causal=True, block_q=block,
                                block_k=block)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("float32"))


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 2), (6, 1), (4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_gqa_matches_jax_ops(Hq, Hkv, dtype, causal):
    """The JAX ops.attention repeats K/V to the query head count first; the
    port reads KV head h // (Hq/Hkv) in place.  Both JAX routes are held."""
    arrs = make_qkv(2, 96, 96, Hq, Hkv, 64, seed=3)
    jd, td = DTYPES[dtype]
    out = ops.attention(*to_torch(arrs, td), causal=causal)
    assert tuple(out.shape) == (2, 96, Hq, 64) and out.dtype == td
    for use_pallas in (False, True):
        ref = jops.attention(*to_jax(arrs, jd), causal=causal,
                             use_pallas=use_pallas)
        np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


def test_plain_impl_and_explicit_scale():
    q, k, v = to_torch(make_qkv(1, 40, 56, 4, 2, 64), torch.float32)
    out = ops.attention(q, k, v, causal=False, impl="plain")
    ref = dense_attention(q, k, v, causal=False)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("float32"))
    assert torch.equal(out, ops.attention(q, k, v, causal=False))
    scaled = flash_attention_plain(q, k, v, causal=False, scale=0.3)
    np.testing.assert_allclose(
        as_np(scaled), as_np(dense_attention(q, k, v, causal=False, scale=0.3)),
        **tol("float32"))


@pytest.mark.parametrize("impl", ["auto", "plain", "kernel"])
def test_ops_attention_window_raises_on_every_route(impl):
    """No sliding window in the kernel or its plain version: no route takes
    one quietly, on any device."""
    q, k, v = to_torch(make_qkv(1, 50, 50, 2, 2, 64), torch.float32)
    with pytest.raises(NotImplementedError, match="window"):
        ops.attention(q, k, v, causal=True, window=9, impl=impl)


def test_ops_attention_kernel_on_cpu_raises():
    q, k, v = to_torch(make_qkv(1, 16, 16, 2, 2, 64), torch.float32)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, causal=True, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")
    assert flash_attention.launches == before      # nothing was launched


def test_auto_on_cpu_takes_plain_and_counts_no_launch():
    q, k, v = to_torch(make_qkv(1, 32, 32, 2, 1, 64), torch.float32)
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_plain(q, k, v, causal=True))


def test_kernel_wrapper_rejects_window_before_anything_else():
    q, k, v = to_torch(make_qkv(1, 16, 16, 2, 2, 64), torch.float32)
    with pytest.raises(NotImplementedError, match="window"):
        flash_attention(q, k, v, window=4)


def test_build_module_names_its_sources_and_needs_no_compiler_to_import():
    assert build.sources() == ["flash_attention", "ssd_scan"]
    assert (build.CSRC / "flash_attention.cu").is_file()
    assert "compute_90a" in " ".join(build.NVCC_FLAGS)
    text = (build.CSRC / "flash_attention.cu").read_text()
    assert 'extern "C" int flash_attention_fwd' in text
    assert "mma.sync" in text
    ssd = (build.CSRC / "ssd_scan.cu").read_text()
    assert 'extern "C" int ssd_scan_fwd' in ssd
    # above 48 KB of shared memory a block needs the attribute raised
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in ssd
    assert "src/repro/kernels/ssd_scan.py" in ssd
    # a source that does not exist is an error, not a silent fallback
    with pytest.raises(FileNotFoundError):
        build.load("no_such_kernel")
