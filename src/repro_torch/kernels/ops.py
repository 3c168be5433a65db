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

Every call reports its kernel's work (FLOPs, bytes: the formula beside the
kernel's wrapper) to ``launch.roofline.count_cost`` while one counts, and the
tensor ops inside the call (the plain version's, on the CPU) count nothing
(``kernels.work``), so a step counts the same on the card and on the CPU.

Every function of the JAX module has its counterpart here: ``attention``,
``ssd``, and the gradient-synchronisation kernels ``reduce_shards``,
``quantize`` and ``dequantize`` (``repro_torch.parallel`` calls them).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import work
from .flash_attention import (FlashAttention, flash_attention, flash_attention_plain,
                              flash_fwd_work)
from .quant8 import dequantize as _dequantize
from .quant8 import dequantize_plain
from .quant8 import quantize as _quantize
from .quant8 import dequantize_work, quantize_plain, quantize_work
from .reduce_tree import tree_reduce, tree_reduce_plain, tree_reduce_work
from .ssd_scan import SSDScan, ssd_fwd_work, ssd_scan, ssd_scan_plain

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
    with work.muted():
        fwd = flash_attention if on_kernel else flash_attention_plain
        out = fwd(q, k, v, causal=causal, window=window)
    work.report(flash_fwd_work, q, k, v, out, causal=causal, window=window)
    return out


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
    with work.muted():
        fwd = ssd_scan if on_kernel else ssd_scan_plain
        got = fwd(x, dt, A, Bmat, Cmat, initial_state=initial_state,
                  return_state=return_state)
    y, final = got if return_state else (got, None)
    work.report(ssd_fwd_work, x, dt, A, Bmat, Cmat, initial_state, y, final)
    return got


def reduce_shards(shards: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Sum of N stacked shards, ``(..., N, L) -> (..., L)``, in fp32 with the
    fixed pairwise tree, cast to the shards' dtype."""
    with work.muted():
        out = (tree_reduce if _on_kernel(impl, shards) else tree_reduce_plain)(shards)
    work.report(tree_reduce_work, shards, out)
    return out


def quantize(x: torch.Tensor, block: int = 1024, *, return_error: bool = False,
             impl: str = "auto"):
    """Blockwise int8 of each row of ``(..., n)``: ``(q, scales)``, and the
    fp32 residual ``x - q * scale`` as a third output if ``return_error``."""
    with work.muted():
        got = (_quantize if _on_kernel(impl, x) else quantize_plain)(
            x, block, return_error=return_error)
    work.report(quantize_work, x, *got)
    return got


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int = 1024, *,
               out_dtype: torch.dtype = torch.float32, impl: str = "auto"):
    """``q * scale`` per block of each row, in ``out_dtype``."""
    with work.muted():
        out = (_dequantize if _on_kernel(impl, q) else dequantize_plain)(
            q, scales, block, out_dtype=out_dtype)
    work.report(dequantize_work, q, scales, out)
    return out
