"""The port's kernel layer on the CPU, held against the JAX package.

``flash_attention_plain`` (the plain PyTorch version that sits beside the
CUDA kernel and repeats its arithmetic) against the Pallas kernel in
interpret mode and against ``dense_attention``, on the same numpy inputs;
``ops.attention`` against the JAX ``ops.attention``.  Likewise the plain
versions of the gradient-synchronisation kernels: ``tree_reduce_plain``
against ``ref_reduce`` and the Pallas ``tree_reduce``, ``quantize_plain`` /
``dequantize_plain`` against ``compress.quantize`` / ``dequantize`` and the
Pallas ``quant8`` kernels, q bit for bit.  The CUDA kernels themselves cannot
run here: ``chip_smoke.py`` holds them against the plain versions on the card.

Tolerances are the reference's own (``tests/test_kernels.py::tol``): fp32
atol 2e-5 / rtol 2e-4 (sums in another order), bf16 atol = rtol = 2e-2 (one
bf16 rounding of the output, and of ``p`` before the second product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant8 as j_q8
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.reduce_tree import ref_reduce as j_ref_reduce
from repro.kernels.reduce_tree import tree_reduce as j_tree_reduce
from repro.models.attention import dense_attention as j_dense
from repro.parallel import compress as j_compress

from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_plain)
from repro_torch.kernels.quant8 import (dequantize, dequantize_plain, quantize,
                                        quantize_plain)
from repro_torch.kernels.reduce_tree import tree_reduce, tree_reduce_plain
from repro_torch.models.attention import dense_attention
from repro_torch.parallel import compress

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
    """The name is historical (kept so that the test's ID stays): every route
    once refused a window.  Now the plain route (and "auto" on the CPU) gives
    ``dense_attention(window=)`` and JAX's ``dense_attention`` on the same
    inputs; the kernel route on a CPU tensor raises the CUDA error of
    ``test_ops_attention_kernel_on_cpu_raises`` and launches nothing."""
    arrs = make_qkv(1, 50, 50, 2, 2, 64)
    q, k, v = to_torch(arrs, torch.float32)
    if impl == "kernel":
        before = flash_attention.launches
        with pytest.raises(ValueError, match="CUDA"):
            ops.attention(q, k, v, causal=True, window=9, impl=impl)
        assert flash_attention.launches == before
        return
    out = ops.attention(q, k, v, causal=True, window=9, impl=impl)
    np.testing.assert_allclose(as_np(out), as_np(dense_attention(q, k, v, causal=True,
                                                                 window=9)),
                               **tol("float32"))
    np.testing.assert_allclose(as_np(out), as_np(j_dense(*to_jax(arrs, jnp.float32),
                                                         causal=True, window=9)),
                               **tol("float32"))


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
    """The name is historical (kept so that the test's ID stays): the wrapper
    once refused every window.  It now takes a window with ``causal=True`` and
    rejects, before anything else, one without the causal mask (no model path
    passes that), a negative one, and a windowed call with more queries than
    keys; a windowed call on CPU tensors is refused like any other."""
    q, k, v = to_torch(make_qkv(1, 16, 16, 2, 2, 64), torch.float32)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="causal=True"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window must be >= 0"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, window=4)
    out, lse = flash_attention_plain(q, k, v, window=4, return_lse=True)
    with pytest.raises(ValueError, match="causal=True"):
        flash_attention_bwd(q, k, v, out, out, lse, causal=False, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, out, out, lse, window=4)
    q2 = to_torch(make_qkv(1, 24, 16, 2, 2, 64), torch.float32)[0]
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q2, k, v, window=4)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def test_build_module_names_its_sources_and_needs_no_compiler_to_import():
    assert build.sources() == ["flash_attention", "flash_attention_bwd", "quant8",
                               "reduce_tree", "ssd_scan", "ssd_scan_bwd"]
    assert (build.CSRC / "flash_attention.cu").is_file()
    assert "compute_90a" in " ".join(build.NVCC_FLAGS)
    text = (build.CSRC / "flash_attention.cu").read_text()
    assert 'extern "C" int flash_attention_fwd' in text
    assert "float* lse" in text          # the optional log-sum-exp output
    bwd = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert 'extern "C" int flash_attention_bwd' in bwd
    assert "mma.sync" in bwd and "atomicAdd" not in bwd   # deterministic: no atomics
    assert "src/repro/kernels/flash_attention.py" in bwd
    # the bf16 paths: wgmma products on tiles loaded by TMA, the helpers shared
    # by forward and backward in one header
    hopper = (build.CSRC / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in hopper
    for src in (text, bwd):
        assert '#include "hopper.cuh"' in src
    assert "wgmma_m64n64k16_ss" in bwd and "tma_load_4d" in bwd and "setmaxnreg" in bwd
    ssd = (build.CSRC / "ssd_scan.cu").read_text()
    assert 'extern "C" int ssd_scan_fwd' in ssd
    # above 48 KB of shared memory a block needs the attribute raised
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in ssd
    assert "src/repro/kernels/ssd_scan.py" in ssd
    assert "mma.sync" in ssd            # the bf16 path's products on the tensor cores
    ssd_bwd = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    assert 'extern "C" int ssd_scan_bwd' in ssd_bwd
    # the gradient of the Pallas kernel's function, as the JAX model trains it
    assert "src/repro/kernels/ssd_scan.py" in ssd_bwd and "src/repro/models/ssm.py:100" in ssd_bwd
    assert "atomicAdd" not in ssd_bwd   # deterministic: no atomics
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in ssd_bwd
    # the bf16 backward's products on the tensor cores (mma.sync, in the shared header)
    mma = (build.CSRC / "mma_sync.cuh").read_text()
    assert "mma16816(" in ssd_bwd and "mma.sync" in mma
    q8 = (build.CSRC / "quant8.cu").read_text()
    for entry in ('extern "C" int quantize_fwd', 'extern "C" int dequantize_fwd'):
        assert entry in q8
    # the rounding points that make q and err bit-equal to the reference
    for op in ("rintf(", "__fdiv_rn(", "__fsub_rn(", "__fmul_rn("):
        assert op in q8, op
    assert "floorf" not in q8.split("#include")[1]
    assert "src/repro/kernels/quant8.py" in q8
    rt = (build.CSRC / "reduce_tree.cu").read_text()
    assert 'extern "C" int tree_reduce_fwd' in rt
    assert "src/repro/kernels/reduce_tree.py" in rt
    assert "--use_fast_math" not in build.NVCC_FLAGS
    # a source that does not exist is an error, not a silent fallback
    with pytest.raises(FileNotFoundError):
        build.load("no_such_kernel")


def test_build_hash_covers_the_headers_a_source_includes(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n#include <stdint.h>\nint f();\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// g\n")
    (tmp_path / "other.cuh").write_text("// included by nothing\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.sources() == ["k"]                   # headers are not built on their own
    assert build._included(tmp_path / "k.cu") == [tmp_path / "h.cuh", tmp_path / "g.cuh"]
    first = build._target("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert build._target("k") == first                # a header k.cu does not include
    (tmp_path / "g.cuh").write_text("// g, edited\n")
    second = build._target("k")
    assert second != first                            # a header included through another
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n// edited\n')
    assert build._target("k") not in (first, second)


def test_both_flash_sources_include_the_shared_header():
    for name in ("flash_attention", "flash_attention_bwd"):
        assert build._included(build.CSRC / f"{name}.cu") == [build.CSRC / "hopper.cuh"]
    # the bf16 SSD kernels, forward and backward, share their mma.sync helpers
    for name in ("ssd_scan", "ssd_scan_bwd"):
        assert build._included(build.CSRC / f"{name}.cu") == [build.CSRC / "mma_sync.cuh"]
    for name in ("quant8", "reduce_tree"):
        assert build._included(build.CSRC / f"{name}.cu") == []


# --------------------------------------------------------------------------
# the gradient-synchronisation kernels: tree reduce, int8 quantize/dequantize
# --------------------------------------------------------------------------

def ref_reduce_rows(shards: torch.Tensor) -> torch.Tensor:
    """``ref_reduce`` written out over a list of rows, as its text reads."""
    rows = [r.float() for r in shards.unbind(0)]
    while len(rows) > 1:
        half = len(rows) // 2
        rows = [rows[i] + rows[i + half] for i in range(half)] + rows[2 * half:]
    return rows[0].to(shards.dtype)


# the reference's sweep (tests/test_kernels.py) as (N, L, block)
TREE_SWEEP = [(2, 100, 64), (7, 1000, 256), (16, 4096, 1024), (33, 513, 128)]


@pytest.mark.parametrize("n,L,block", TREE_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_reduce_plain_matches_ref_reduce_and_pallas(n, L, block, dtype):
    jd, td = DTYPES[dtype]
    a = np.random.default_rng(n).standard_normal((n, L), np.float32) * 2
    shards = torch.from_numpy(a).to(td)
    out = tree_reduce_plain(shards)
    assert out.dtype == td and tuple(out.shape) == (L,)
    assert torch.equal(out, ref_reduce_rows(shards))          # same pairing, bit for bit
    xj = jnp.asarray(a).astype(jd)
    np.testing.assert_allclose(as_np(out), as_np(j_ref_reduce(xj)), **tol(dtype))
    np.testing.assert_allclose(as_np(out), as_np(j_tree_reduce(xj, block=block)),
                               **tol(dtype))
    if dtype == "float32":
        # the pairing is the reference's: IEEE adds in the same order
        np.testing.assert_array_equal(as_np(out), as_np(j_ref_reduce(xj)))


def test_tree_reduce_plain_batches_and_strided_views():
    """(..., N, L): every leading index reduced on its own, also when the N
    axis is a strided view (the stacked sync's (P, D_recv, D_src, s))."""
    a = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4, 4 * 9), np.float32))
    view = a.view(2, 4, 4, 9).transpose(1, 2)                # (P, recv, src, s)
    out = tree_reduce_plain(view)
    assert tuple(out.shape) == (2, 4, 9)
    for p in range(2):
        for r in range(4):
            assert torch.equal(out[p, r], ref_reduce_rows(view[p, r]))


def make_quant_input(n, seed=7, scale=5.0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * scale


def tie_input(block=64):
    """One block whose amax is exactly 127, so scale is exactly 1 and
    x = k + 0.5 are exact ties of round(): half to even and floor(x + 0.5)
    give different q."""
    x = np.arange(block, dtype=np.float32) - block / 2 + 0.5
    x[0] = 127.0
    return x


QUANT_CASES = [(100, 64), (5000, 512), (4096, 1024)]


@pytest.mark.parametrize("n,block", QUANT_CASES + [("tie", 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_bit_equal_to_jax(n, block, dtype):
    jd, td = DTYPES[dtype]
    a = tie_input(block) if n == "tie" else make_quant_input(n)
    x_t = torch.from_numpy(a).to(td)
    x_j = jnp.asarray(a).astype(jd)
    q, s = quantize_plain(x_t, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    for qj, sj in (j_compress.quantize(x_j, block), j_q8.quantize(x_j, block)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6)
    # jnp divides by 127 with IEEE rounding (the Pallas kernel in interpret
    # mode multiplies by the reciprocal, hence the rtol above): so do we
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_compress.quantize(x_j, block)[1]))
    amax = np.maximum(np.abs(np.pad(as_np(x_t), (0, -len(a) % block))).reshape(-1, block)
                      .max(1), np.float32(1e-20))
    np.testing.assert_array_equal(s.numpy(), amax / np.float32(127.0))
    if n == "tie":
        assert float(s[0]) == 1.0
        body = a[1:]
        assert np.array_equal(q.numpy()[1:], np.round(body).astype(np.int8))  # half to even
        assert not np.array_equal(q.numpy()[1:], np.floor(body + 0.5).astype(np.int8))


@pytest.mark.parametrize("n,block", QUANT_CASES)
def test_ef_residual_and_dequantize_match_jax(n, block):
    a = make_quant_input(n, seed=n)
    x_t, x_j = torch.from_numpy(a), jnp.asarray(a)
    q, s, err = compress.ef_quantize(x_t, block)
    qj, sj, ej = j_compress.ef_quantize(x_j, block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(err.numpy(), np.asarray(ej))
    # dequantize of the same (q, scales) through all three routes
    dq = dequantize_plain(q, s, block)
    np.testing.assert_array_equal(dq.numpy(), np.asarray(j_compress.dequantize(qj, sj, block)))
    np.testing.assert_array_equal(dq.numpy(), np.asarray(j_q8.dequantize(qj, sj, block)))
    bf = dequantize_plain(q, s, block, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        as_np(bf), as_np(j_q8.dequantize(qj, sj, block, out_dtype=jnp.bfloat16)))
    # the quantization error is at most half a quantum per block
    assert float((dq - x_t).abs().max()) <= float(s.max()) * 0.51
    assert torch.equal(err, x_t - dq)


def test_quantize_plain_rows_are_separate_jax_calls():
    """A 2-D input (rows, n): each row pads and starts its blocks on its own."""
    a = np.stack([make_quant_input(300, seed=s, scale=1.0 + s) for s in range(3)])
    q, s, err = quantize_plain(torch.from_numpy(a), 128, return_error=True)
    assert tuple(q.shape) == (3, 300) and tuple(s.shape) == (3, 3)
    for r in range(3):
        qj, sj, ej = j_compress.ef_quantize(jnp.asarray(a[r]), 128)
        np.testing.assert_array_equal(q[r].numpy(), np.asarray(qj))
        np.testing.assert_allclose(s[r].numpy(), np.asarray(sj), rtol=1e-6)
        np.testing.assert_array_equal(err[r].numpy(), np.asarray(ej))
    # a strided view of the same rows gives the same result
    wide = torch.zeros(3, 2, 300)
    wide[:, 1] = torch.from_numpy(a)
    q2, s2 = quantize_plain(wide[:, 1], 128)
    assert torch.equal(q2, q) and torch.equal(s2, s)
    assert torch.equal(dequantize_plain(q, s, 128), torch.stack(
        [dequantize_plain(q[r], s[r], 128) for r in range(3)]))


def test_compression_ratio_matches_jax():
    for n, block in [(1, 1024), (4097, 1024), (10 ** 6, 512)]:
        assert compress.compression_ratio(n, block) == j_compress.compression_ratio(n, block)
    assert compress.BLOCK == j_compress.BLOCK


def test_sync_kernels_dispatch_by_device_and_never_fall_back():
    x = torch.from_numpy(make_quant_input(300))
    shards = x.view(3, 100)
    before = (tree_reduce.launches, quantize.launches, dequantize.launches)
    assert torch.equal(ops.reduce_shards(shards), tree_reduce_plain(shards))
    q, s = ops.quantize(x, 64)
    assert torch.equal(q, quantize_plain(x, 64)[0])
    assert torch.equal(ops.dequantize(q, s, 64), dequantize_plain(q, s, 64))
    assert (tree_reduce.launches, quantize.launches, dequantize.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.reduce_shards(shards, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.quantize(x, 64, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.dequantize(q, s, 64, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.reduce_shards(shards, impl="pallas")
    with pytest.raises(ValueError, match="match"):
        dequantize_plain(q, s[:-1], 64)
    assert (tree_reduce.launches, quantize.launches, dequantize.launches) == before


def test_batch3_merges_views_and_refuses_more_than_three_dimensions():
    t = torch.zeros(2, 4, 4, 9).transpose(1, 2)               # (2, 4, 4) batch of a view
    assert build.batch3(t.shape[:-1], t.stride()[:-1], what="t") == \
        ([2, 4, 4], [144, 9, 36])
    c = torch.zeros(2, 3, 5, 7)
    assert build.batch3(c.shape[:-1], c.stride()[:-1], what="c") == ([1, 1, 30], [0, 0, 7])
    # two tensors indexed by one batch merge only where both can
    q, s = torch.zeros(4, 2, 8), torch.zeros(2, 4, 1).transpose(0, 1)
    assert build.batch3(q.shape[:-1], q.stride()[:-1], s.stride()[:-1], what="qs") == \
        ([1, 4, 2], [0, 16, 8], [0, 1, 4])
    odd = torch.zeros(2, 3, 2, 3, 5)[:, :, :, :, :1].permute(3, 1, 0, 2, 4)
    with pytest.raises(ValueError, match="three"):
        build.batch3(odd.shape[:-1], odd.stride()[:-1], what="odd")
