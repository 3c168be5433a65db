"""Minimal module substrate of the port: plain functions on tensors.

Counterpart of ``repro.models.modules``.  Parameters are nested dictionaries
of ``torch.Tensor`` with the JAX package's names (``embed``, ``final_norm``,
``blocks.{ln1, attn.{wq, wk, wv, wo, bq, bk, bv, q_norm, k_norm}, ln2,
ffn.{w_gate, w_up, w_down}}``), so a value tree of one package converts to
the other leaf by leaf (``repro_torch.convert``).  The ``Box`` / ``AxisNames``
sharding metadata of the JAX package arrives with the sharding slice.

Initialisers draw from an explicit ``torch.Generator`` that lives on the
target device; they never touch the global generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """Apply ``fn`` to every tensor of a parameter tree (nested dicts and
    lists, as ``transformer.init`` returns)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA request without CUDA raises.

    Entry points default to ``"cuda"``: the CPU is used only when the caller
    asks for it by name.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, the usual transformer default."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) <= 2 else int(math.prod(shape[:-1]))
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (w * std).to(dtype)


def zeros_init(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# core ops
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation (returns x.dtype)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation, which is what jax.nn.gelu computes by default
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)
