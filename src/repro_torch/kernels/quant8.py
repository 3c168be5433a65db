"""Blockwise symmetric int8 quantize / dequantize: the wrappers of the
hand-written CUDA kernels and, beside them, the plain PyTorch versions of the
same arithmetic.

Counterpart of ``repro.kernels.quant8`` (the Pallas TPU kernels) and of the jnp
functions they are held against, ``repro.parallel.compress.quantize`` /
``dequantize``.  The kernels' source is ``csrc/quant8.cu``; the note at its top
says what they replace, what bounds them on an H100 and which rounding points
make q bit-equal to the reference.

* ``quantize(x, block, return_error=)`` and ``dequantize(q, scales, block,
  out_dtype=)`` launch the kernels.  They take CUDA tensors only and raise on
  anything the kernels do not take; they never fall back to the plain
  versions.  ``quantize.launches`` and ``dequantize.launches`` count the
  launches.
* ``quantize_plain`` and ``dequantize_plain`` are ``compress.quantize`` and
  ``compress.dequantize`` in tensor ops: the oracles the kernels are held
  against on the card (bit for bit), and what ``ops.quantize`` /
  ``ops.dequantize`` take for a tensor that lies on the CPU.

Per block of ``block`` values: ``scale = max(amax, 1e-20) / 127``,
``q = clip(round(x / scale), -127, 127)`` (half to even) as int8, scales fp32;
``dequantize`` gives ``q * scale`` in ``out_dtype``.  With ``return_error``
quantize also returns the error-feedback residual ``x - q * scale`` (fp32),
which the kernel computes in the same pass.  A 2-D or higher input
``(..., n)`` is one JAX call per row: each row is padded to whole blocks and
starts its blocks on its own, so scales are ``(..., ceil(n / block))``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, work

MAX_BLOCK = 12288                 # the kernel keeps one block in shared memory
_DTYPES = (torch.float32, torch.bfloat16)

_fns = {}


def _kernel_fn(name: str):
    """The C entry points, built and bound at first use."""
    if name not in _fns:
        lib = build.load("quant8")
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if name == "quantize_fwd":
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] +
                           [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 +
                           [ctypes.c_int, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] +
                           [ctypes.c_int] * 3 + [ctypes.c_longlong] * 6 +
                           [ctypes.c_int, ctypes.c_void_p])
        _fns[name] = fn
    return _fns[name]


def _n_blocks(n: int, block: int) -> int:
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    return -(-n // block)


def quantize(x: torch.Tensor, block: int = 1024, *, return_error: bool = False):
    """x: CUDA ``(..., n)``, fp32 or bf16, last dimension contiguous.

    Returns ``(q, scales)`` or, with ``return_error``, ``(q, scales, err)``:
    q int8 ``(..., n)``, scales fp32 ``(..., ceil(n / block))``, err fp32
    ``(..., n)``.  Launches on the current stream and does not synchronise.
    """
    if not x.is_cuda:
        raise ValueError(f"quantize launches a CUDA kernel: x lies on {x.device}; "
                         "for a CPU tensor call quantize_plain (ops.quantize does)")
    if x.dim() < 1:
        raise ValueError("x must have at least one dimension")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be in [1, {MAX_BLOCK}], got {block}")
    n = x.shape[-1]
    if n > 1 and x.stride(-1) != 1:
        raise ValueError("x: the last dimension must be contiguous")
    lead, dev = x.shape[:-1], x.device
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scales = torch.empty(lead + (_n_blocks(n, block),), dtype=torch.float32, device=dev)
    err = torch.empty(x.shape, dtype=torch.float32, device=dev) if return_error else None
    if q.numel():
        sizes, strides = build.batch3(lead, x.stride()[:-1], what="quantize")
        fn = _kernel_fn("quantize_fwd")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                      err.data_ptr() if err is not None else None, n, block,
                      *sizes, *strides, int(x.dtype == torch.bfloat16), stream)
        if code != 0:
            raise RuntimeError(f"quantize_fwd failed to launch (code {code}) for x "
                               f"{tuple(x.shape)} {x.dtype} block {block}")
        quantize.launches += 1
    return (q, scales, err) if return_error else (q, scales)


quantize.launches = 0


def _check_dequantize(q: torch.Tensor, scales: torch.Tensor, block: int):
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"need q int8 and scales float32, got {q.dtype}, {scales.dtype}")
    if q.dim() < 1 or q.shape[:-1] != scales.shape[:-1] or \
            scales.shape[-1] != _n_blocks(q.shape[-1], block):
        raise ValueError(f"q {tuple(q.shape)} and scales {tuple(scales.shape)} do "
                         f"not match at block {block}")


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int = 1024, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: CUDA int8 ``(..., n)``; scales: fp32 ``(..., ceil(n / block))``; both
    with the last dimension contiguous.  Returns ``(..., n)`` in ``out_dtype``
    (fp32 or bf16).  Launches on the current stream and does not synchronise.
    """
    for name, t in (("q", q), ("scales", scales)):
        if not t.is_cuda:
            raise ValueError(f"dequantize launches a CUDA kernel: {name} lies on "
                             f"{t.device}; for a CPU tensor call dequantize_plain "
                             "(ops.dequantize does)")
        if t.device != q.device:
            raise ValueError("q and scales must lie on one device")
        if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    _check_dequantize(q, scales, block)
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not supported (float32, bfloat16)")
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel():
        qs, qst, sst = build.batch3(q.shape[:-1], q.stride()[:-1], scales.stride()[:-1],
                                    what="dequantize")
        fn = _kernel_fn("dequantize_fwd")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.shape[-1],
                      block, *qs, *qst, *sst, int(out_dtype == torch.bfloat16), stream)
        if code != 0:
            raise RuntimeError(f"dequantize_fwd failed to launch (code {code}) for q "
                               f"{tuple(q.shape)} block {block}")
        dequantize.launches += 1
    return out


dequantize.launches = 0


def quantize_work(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                  err: Optional[torch.Tensor] = None):
    """(FLOPs, bytes) of one quantize: x read once, q, the scales (and the
    residual) written once; no FLOPs, as ``tree_reduce_work``."""
    return 0, work.nbytes(x, q, scales, err)


def dequantize_work(q: torch.Tensor, scales: torch.Tensor, out: torch.Tensor):
    """(FLOPs, bytes) of one dequantize: q and the scales read once, the
    values written once; no FLOPs, as ``tree_reduce_work``."""
    return 0, work.nbytes(q, scales, out)


def quantize_plain(x: torch.Tensor, block: int = 1024, *, return_error: bool = False):
    """``compress.quantize`` (and, with ``return_error``, ``ef_quantize``'s
    residual) in tensor ops, row by row over the last dimension, on any
    device."""
    n = x.shape[-1]
    nb = _n_blocks(n, block)
    lead = x.shape[:-1]
    xf = torch.nn.functional.pad(x.float(), (0, nb * block - n)).reshape(lead + (nb, block))
    amax = torch.clamp_min(xf.abs().amax(dim=-1), 1e-20)
    # a tensor divisor: on CUDA, division by a Python number is a multiply by
    # its reciprocal, which misses IEEE division (what jnp and the kernel do)
    # by one ulp in about 4 % of the blocks
    scales = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scales[..., None]), -127, 127).to(torch.int8)
    q = q.reshape(lead + (nb * block,))[..., :n]
    if not return_error:
        return q, scales
    return q, scales, x.float() - dequantize_plain(q, scales, block)


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor, block: int = 1024, *,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``compress.dequantize`` in tensor ops, on any device: ``q * scale`` in
    fp32, then cast to ``out_dtype``."""
    _check_dequantize(q, scales, block)
    n, nb = q.shape[-1], scales.shape[-1]
    lead = q.shape[:-1]
    qf = torch.nn.functional.pad(q, (0, nb * block - n)).reshape(lead + (nb, block)).float()
    x = (qf * scales[..., None]).reshape(lead + (nb * block,))[..., :n]
    return x.to(out_dtype)
