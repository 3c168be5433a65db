"""AdamW from scratch, with mixed precision and memory modes.

Counterpart of ``repro.train.optim``, function for function:

* ``master=True``  — fp32 master copy of the (bf16) params; updates applied
  to the master, params re-cast each step (the standard mixed-precision
  recipe).
* ``master=False`` — params updated in their own dtype with fp32 math.
* ``moments_dtype`` ∈ {float32, bfloat16, int8} — int8 stores blockless
  *per-row* quantized moments (scale shape = param.shape[:-1]), the 8-bit
  Adam memory trick.  A sharded setup whose ranks hold pieces of a row passes
  ``adam_update(row_max=)``, so that the scale is the whole row's.

``OptimConfig`` is the port's own copy of the JAX package's, field for field
(``tests/test_torch_optim.py`` holds the two equal).  All state leaves mirror
the parameter tree.

One deliberate difference: JAX arrays are immutable and the JAX step returns
new parameters and a new state; ``adam_update`` here computes each leaf's new
values as the JAX function does and then writes them **in place** into the
parameter, master and moment tensors it was given (and returns those same
objects), so a step never holds two copies of the model or its state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.modules import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master: bool = True
    moments_dtype: str = "float32"   # float32 | bfloat16 | int8


class QTensor(NamedTuple):
    """Per-row int8 quantized tensor (non-negative ⇒ unsigned mapping)."""
    q: torch.Tensor          # int8, same shape as the original
    scale: torch.Tensor      # fp32, shape = original.shape[:-1] (or () for 1-d)


class AdamState(NamedTuple):
    step: torch.Tensor       # int32 scalar, on the CPU
    master: Any              # fp32 params or None
    m: Any                   # moments (tensor | QTensor per leaf)
    v: Any


def _quantize(x: torch.Tensor, signed: bool, row_max=None) -> QTensor:
    # bf16 quantization input, as the reference: int8 output precision is
    # unaffected (7 bits << bf16's 8 mantissa bits)
    xf = x.to(torch.bfloat16).float()
    amax = xf.abs().amax(dim=-1) if x.dim() > 1 else xf.abs().amax()
    if row_max is not None:
        # a sharded row: the max over the ranks that hold its pieces
        amax = row_max(amax)
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.round(xf / scale[..., None] if x.dim() > 1 else xf / scale)
    q = torch.clamp(q, -127 if signed else 0, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.float())


def _dequantize(t: QTensor) -> torch.Tensor:
    s = t.scale[..., None] if t.q.dim() > 1 else t.scale
    return t.q.float() * s


def _encode_moment(x: torch.Tensor, dtype: str, signed: bool, row_max=None):
    if dtype == "int8":
        return _quantize(x, signed, row_max)
    return x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _decode_moment(x) -> torch.Tensor:
    if isinstance(x, QTensor):
        return _dequantize(x)
    return x.float()


def _store_moment(buf, new) -> None:
    """Write a freshly encoded moment into the state's buffers."""
    if isinstance(buf, QTensor):
        buf.q.copy_(new.q)
        buf.scale.copy_(new.scale)
    else:
        buf.copy_(new)


def init_adam(params, ocfg: OptimConfig) -> AdamState:
    """Zero moments (encoded as ``moments_dtype``) and, with ``master``, an
    fp32 copy of the params, each on its parameter's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(
        step=torch.zeros((), dtype=torch.int32),
        master=(tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
                if ocfg.master else None),
        m=tree_map(lambda p: _encode_moment(zeros(p), ocfg.moments_dtype, True), params),
        v=tree_map(lambda p: _encode_moment(zeros(p), ocfg.moments_dtype, False), params),
    )


def lr_schedule(step, ocfg: OptimConfig) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``, in fp32 as the
    reference computes it.  Returns an fp32 scalar on the CPU."""
    step = torch.as_tensor(step).to(torch.float32).cpu()
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - ocfg.warmup_steps) /
                       max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return ocfg.lr * warm * (ocfg.min_lr_ratio + (1 - ocfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_flatten(tree)[0]]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _is_moment(x) -> bool:
    return isinstance(x, QTensor)


@torch.no_grad()
def adam_update(params, grads, state: AdamState, ocfg: OptimConfig,
                gnorm: Optional[torch.Tensor] = None,
                row_max: Optional[Sequence[Optional[Callable]]] = None
                ) -> Tuple[Any, AdamState, dict]:
    """One AdamW step, in place.  Returns (params, new_state, metrics):
    ``params`` and the state's master and moment buffers are the objects
    passed in, their values overwritten; ``new_state.step`` is new.  The
    clip factor comes from ``gnorm``, by default the global norm of
    ``grads``; a ZeRO-1 or FSDP rank that updates its shard of the tree
    passes the norm of the whole gradient.  ``row_max`` (one entry per leaf,
    int8 moments only): for a leaf whose rows are split over ranks, the
    function that turns each piece's amax into the whole row's, so that the
    scale is the one the whole row takes; None where a row is whole."""
    step = state.step + 1
    lr = lr_schedule(step, ocfg)
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = (torch.clamp(ocfg.grad_clip / torch.clamp_min(gnorm, 1e-12), max=1.0)
            if ocfg.grad_clip else 1.0)

    b1, b2 = ocfg.b1, ocfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def leaf(p, g, m, v, mw, rm):
        g = g.float() * clip
        mf = _decode_moment(m)
        vf = _decode_moment(v)
        mf = b1 * mf + (1 - b1) * g
        vf = b2 * vf + (1 - b2) * torch.square(g)
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + ocfg.eps)
        base = mw if mw is not None else p.float()
        new_master = base - lr * (upd + ocfg.weight_decay * base)
        _store_moment(m, _encode_moment(mf, ocfg.moments_dtype, True, rm))
        _store_moment(v, _encode_moment(vf, ocfg.moments_dtype, False, rm))
        if mw is not None:
            mw.copy_(new_master)
        p.copy_(new_master)

    p_flat, _ = tree_flatten(params)
    g_flat = tree_flatten(grads)[0]
    m_flat = tree_flatten(state.m, is_leaf=_is_moment)[0]
    v_flat = tree_flatten(state.v, is_leaf=_is_moment)[0]
    mw_flat = (tree_flatten(state.master)[0] if state.master is not None
               else [None] * len(p_flat))
    rm_flat = list(row_max) if row_max is not None else [None] * len(p_flat)
    if not len(p_flat) == len(g_flat) == len(m_flat) == len(v_flat) == len(mw_flat) == \
            len(rm_flat):
        raise ValueError("params, grads and optimizer state differ in structure")
    for p, g, m, v, mw, rm in zip(p_flat, g_flat, m_flat, v_flat, mw_flat, rm_flat):
        leaf(p, g, m, v, mw, rm)
    new_state = AdamState(step=step, master=state.master, m=state.m, v=state.v)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
