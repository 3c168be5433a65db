"""Pairwise tree reduction of stacked shards: the wrapper of the hand-written
CUDA kernel and, beside it, the plain PyTorch version of the same arithmetic.

Counterpart of ``repro.kernels.reduce_tree`` (the Pallas TPU kernel, the
R-µswitch analogue that a reduce-scatter or all-reduce runs over the shards
that arrived).  The kernel's source is ``csrc/reduce_tree.cu``; the note at its
top says what it replaces, what bounds it on an H100 and what its design does
about it.

* ``tree_reduce(shards, block=)`` launches the kernel.  It takes CUDA tensors
  only and raises on anything the kernel does not take; it never falls back to
  the plain version.  ``tree_reduce.launches`` counts the launches.
* ``tree_reduce_plain`` is ``ref_reduce`` in tensor ops: the oracle the kernel
  is held against on the card (bit for bit), and what ``ops.reduce_shards``
  takes for a tensor that lies on the CPU.

Shapes: ``(..., N, L) -> (..., L)`` in the shards' dtype, the sum over N in
fp32 with ``ref_reduce``'s pairing.  Unlike the Pallas kernel, which takes one
``(N, L)`` array, the leading dimensions are a batch read through strides, so a
strided view of gradients is reduced without a copy.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, work

MAX_SHARDS = 64                   # the kernel's instantiations: N = 1..64
_DTYPES = (torch.float32, torch.bfloat16)

_fn = None


def _kernel_fn():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        lib = build.load("reduce_tree")
        fn = lib.tree_reduce_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong] +
                       [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 +
                       [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def tree_reduce(shards: torch.Tensor, *, block: int = 4096) -> torch.Tensor:
    """shards: CUDA ``(..., N, L)``, fp32 or bf16, last dimension contiguous.

    Returns ``(..., L)`` in the shards' dtype.  ``block`` is taken for the
    JAX function's signature; the kernel tiles L its own way and the result
    does not depend on it.  Launches on the current stream and does not
    synchronise.
    """
    if not shards.is_cuda:
        raise ValueError(f"tree_reduce launches a CUDA kernel: shards lie on "
                         f"{shards.device}; for a CPU tensor call "
                         "tree_reduce_plain (ops.reduce_shards does)")
    if shards.dim() < 2:
        raise ValueError(f"shards must be (..., N, L), got {tuple(shards.shape)}")
    if shards.dtype not in _DTYPES:
        raise ValueError(f"dtype {shards.dtype} not supported (float32, bfloat16)")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    n, L = shards.shape[-2], shards.shape[-1]
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"the kernel sums 1 to {MAX_SHARDS} shards, got {n}")
    if L > 1 and shards.stride(-1) != 1:
        raise ValueError("shards: the last dimension must be contiguous")
    out = torch.empty(shards.shape[:-2] + (L,), dtype=shards.dtype,
                      device=shards.device)
    if out.numel() == 0:
        return out
    sizes, strides = build.batch3(shards.shape[:-2], shards.stride()[:-2],
                                  what="tree_reduce")
    fn = _kernel_fn()
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(shards.data_ptr(), out.data_ptr(), n, L, *sizes, *strides,
                 shards.stride(-2), int(shards.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"tree_reduce_fwd failed to launch (code {err}) for "
                           f"shards {tuple(shards.shape)} {shards.dtype}")
    tree_reduce.launches += 1
    return out


tree_reduce.launches = 0


def tree_reduce_work(shards: torch.Tensor, out: torch.Tensor):
    """(FLOPs, bytes) of one call: the shards read once and the sum written
    once; its additions count no FLOPs, as ``torch.utils.flop_counter``
    counts an elementwise sum (a few operations an element: the bytes bound
    it)."""
    return 0, work.nbytes(shards, out)


def tree_reduce_plain(shards: torch.Tensor) -> torch.Tensor:
    """``ref_reduce`` over dimension -2, on any device: fp32 (float64 for
    float64 shards, which the kernel does not take: a gradient check), the
    first half plus the second half, an odd last shard carried to the next
    level, until one row is left; cast to the shards' dtype."""
    x = shards.to(torch.promote_types(shards.dtype, torch.float32))
    m = x.shape[-2]
    while m > 1:
        half = m // 2
        head = x[..., :half, :] + x[..., half:2 * half, :]
        x = head if m % 2 == 0 else torch.cat([head, x[..., 2 * half:, :]], dim=-2)
        m = x.shape[-2]
    return x[..., 0, :].to(shards.dtype)
