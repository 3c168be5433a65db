"""Turns the JAX package's parameters into the port's.

``from_jax_params`` takes the *value tree* of the JAX package
(``modules.split(transformer.init(...))[0]``) handed over as nested
dictionaries of **numpy** arrays, block parameters stacked on a leading
``layers`` axis, and returns the port's parameter dictionary: the same names,
``blocks`` unstacked into one dictionary per layer.  Dense blocks are
``{ln1, attn, ln2, ffn}``, MoE blocks the same with ``ffn`` holding
``{router, w_gate, w_up, w_down}`` (experts on the leading axis) and, for
arctic, a third level ``ffn.dense.{w_gate, w_up, w_down}``; Mamba2 blocks
(ssm, hybrid) are ``{ln, ssm}``; the hybrid's ``shared_attn`` is one unstacked
attention block and is converted as it is.  Every level is walked the same
way, however deep.  Both packages then
compute the same function, which is what the parity tests rest on.

Takes numpy only and imports no JAX: the caller converts
(``jax.tree.map(np.asarray, values)``).

``to_jax_params`` is the inverse: the port's parameters back to a numpy tree
in the JAX layout (``blocks`` stacked on a leading ``layers`` axis), so that
tests can hold the two packages' parameters against each other after
training steps.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.config import ModelConfig
from .models.modules import resolve_device
from .models.transformer import PORTED_FAMILIES


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in (np.float16, np.float32, np.float64):
        # e.g. ml_dtypes bfloat16, which torch.from_numpy does not take
        a = a.astype(np.float32)
    # torch.tensor copies: the result never aliases the caller's array
    return torch.tensor(a).to(device=device, dtype=dtype)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def _layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return np.asarray(tree)[l]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def from_jax_params(values: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """JAX value tree (numpy leaves) → repro_torch parameters."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    dev = resolve_device(device)
    unstacked = ("embed", "final_norm", "lm_head") + \
        (("shared_attn",) if cfg.family == "hybrid" else ())
    extra = set(values) - set(unstacked) - {"blocks"}
    if extra:
        raise ValueError(f"unexpected parameter groups {sorted(extra)}")
    out = {k: _convert(values[k], dev, dtype) for k in unstacked if k in values}
    n_layers = max(cfg.num_layers, 1)
    leads = {a.shape[0] if a.ndim else 0 for a in _leaves(values["blocks"])}
    if leads != {n_layers}:
        raise ValueError(f"blocks are stacked {sorted(leads)} deep, the "
                         f"configuration has {n_layers} layers")
    out["blocks"] = [_convert(_layer(values["blocks"], l), dev, dtype)
                     for l in range(n_layers)]
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16: such leaves come back as float32 (exact)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return _numpy(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def to_jax_params(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """repro_torch parameters → JAX value tree (numpy leaves, ``blocks``
    stacked on a leading ``layers`` axis; bf16 tensors as float32 arrays)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    out = {k: _to_numpy_tree(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = _stack([_to_numpy_tree(b) for b in params["blocks"]])
    return out
