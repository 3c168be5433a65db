"""Dispatch layer over the hand-written kernels.

Counterpart of ``repro.kernels.ops``, whose ``use_pallas`` flag chooses between
the Pallas kernel and the jnp reference.  Here the tensor's device chooses:
``impl="auto"`` launches the CUDA kernel for a CUDA tensor and takes the plain
version for a CPU tensor, and only because it lies on the CPU.  There is no
path from a CUDA tensor to the plain version under ``"auto"``, and no ``try``
that gives way to it.  ``impl="plain"`` and ``impl="kernel"`` force one
(``"kernel"`` on a CPU tensor raises).  Model code reaches the kernels through
this module only.

A sliding window (``window > 0``, mixtral's) goes to the kernel or the plain
version like any other call: on a CUDA tensor the kernels skip the key tiles
outside a query tile's window and mask the edge tiles (they take a window only
with ``causal=True``, and raise otherwise), on the CPU the plain versions do
the same.  The Pallas kernel the port replaces has no window.

Gradients: an ``attention`` call whose inputs require a gradient (with
gradients enabled) goes through ``FlashAttention``, which pairs the forward
with its backward (kernel with kernel, plain with plain), and such an
``ssd`` call goes through ``SSDScan`` likewise; any other call runs the
forward alone.

Every function of the JAX module has its counterpart here: ``attention``,
``ssd``, and the gradient-synchronisation kernels ``reduce_shards``,
``quantize`` and ``dequantize`` (``repro_torch.parallel`` calls them).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (FlashAttention, flash_attention,
                              flash_attention_plain)
from .quant8 import dequantize as _dequantize
from .quant8 import dequantize_plain
from .quant8 import quantize as _quantize
from .quant8 import quantize_plain
from .reduce_tree import tree_reduce, tree_reduce_plain
from .ssd_scan import SSDScan, ssd_scan, ssd_scan_plain

IMPLS = ("auto", "kernel", "plain")


def _on_kernel(impl: str, t: torch.Tensor) -> bool:
    """Whether ``impl`` sends tensor ``t`` to the kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "kernel" or (impl == "auto" and t.is_cuda)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, impl: str = "auto",
              window: int = 0) -> torch.Tensor:
    """Self-attention over a full sequence.  q: (B,Sq,Hq,hd); k/v:
    (B,Sk,Hkv,hd) with Hkv dividing Hq (grouped-query attention is read in
    place, K/V are not repeated in memory).  ``window > 0``: query i sees
    keys i - window < j <= i.  Returns (B,Sq,Hq,hd)."""
    on_kernel = _on_kernel(impl, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, None, on_kernel, window)
    if on_kernel:
        return flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bmat: torch.Tensor, Cmat: torch.Tensor, *,
        initial_state: Optional[torch.Tensor] = None,
        return_state: bool = False, impl: str = "auto"):
    """Mamba2 SSD chunked scan.  x: (B,S,H,hd); dt: (B,S,H) fp32; A: (H,)
    fp32; B/C: (B,S,G,N) read in place per group.  Returns y (B,S,H,hd) and,
    if ``return_state``, the final state (B,H,hd,N) fp32.  A call whose
    inputs require a gradient (with gradients enabled) goes through
    ``SSDScan``: on a CUDA tensor the forward and backward kernels."""
    on_kernel = _on_kernel(impl, x)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in
                                       (x, dt, A, Bmat, Cmat, initial_state)):
        y, final = SSDScan.apply(x, dt, A, Bmat, Cmat, initial_state, on_kernel)
        return (y, final) if return_state else y
    if on_kernel:
        return ssd_scan(x, dt, A, Bmat, Cmat, initial_state=initial_state,
                        return_state=return_state)
    return ssd_scan_plain(x, dt, A, Bmat, Cmat, initial_state=initial_state,
                          return_state=return_state)


def reduce_shards(shards: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Sum of N stacked shards, ``(..., N, L) -> (..., L)``, in fp32 with the
    fixed pairwise tree, cast to the shards' dtype."""
    if _on_kernel(impl, shards):
        return tree_reduce(shards)
    return tree_reduce_plain(shards)


def quantize(x: torch.Tensor, block: int = 1024, *, return_error: bool = False,
             impl: str = "auto"):
    """Blockwise int8 of each row of ``(..., n)``: ``(q, scales)``, and the
    fp32 residual ``x - q * scale`` as a third output if ``return_error``."""
    if _on_kernel(impl, x):
        return _quantize(x, block, return_error=return_error)
    return quantize_plain(x, block, return_error=return_error)


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int = 1024, *,
               out_dtype: torch.dtype = torch.float32, impl: str = "auto"):
    """``q * scale`` per block of each row, in ``out_dtype``."""
    if _on_kernel(impl, q):
        return _dequantize(q, scales, block, out_dtype=out_dtype)
    return dequantize_plain(q, scales, block, out_dtype=out_dtype)
