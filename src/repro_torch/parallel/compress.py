"""Gradient compression: blockwise int8 quantization with error feedback.

Counterpart of ``repro.parallel.compress``.  The software analogue of FRED's
in-network traffic halving: EF-int8 quarters the cross-pod payload (against
bf16) at equal convergence, because error feedback carries the quantization
residual into the next step (Seide et al. 2014, Karimireddy et al. 2019).

Every function goes through ``kernels.ops``: on a CUDA tensor the
hand-written kernels of ``csrc/quant8.cu`` run, on a CPU tensor their plain
versions.  ``ef_quantize`` takes the residual from the quantize kernel's fused
second output on the card; the plain path computes it as the JAX function
does, ``x - dequantize(q, scale)``.  Inputs may carry leading dimensions: each
row of ``(..., n)`` is quantized as one JAX call.
"""

from __future__ import annotations

import torch

from ..kernels import ops

BLOCK = 1024


def quantize(x: torch.Tensor, block: int = BLOCK):
    """x: (..., n) → (q int8 (..., n), scale fp32 (..., ceil(n/block)))."""
    return ops.quantize(x, block)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               block: int = BLOCK) -> torch.Tensor:
    return ops.dequantize(q, scale, block)


def ef_quantize(x: torch.Tensor, block: int = BLOCK):
    """Error-feedback quantization: returns (q, scale, error) where
    error = x − dequantize(q, scale) (fp32) is carried to the next step."""
    return ops.quantize(x, block, return_error=True)


def compression_ratio(n: int, block: int = BLOCK,
                      wire_dtype_bytes: int = 2) -> float:
    """Wire-byte ratio vs an uncompressed transfer of the same payload."""
    comp = n * 1 + (-(-n // block)) * 4
    return comp / (n * wire_dtype_bytes)
