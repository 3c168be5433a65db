"""Turns the JAX package's parameters into the port's.

``from_jax_params`` takes the *value tree* of the JAX package
(``modules.split(transformer.init(...))[0]``) handed over as nested
dictionaries of **numpy** arrays, block parameters stacked on a leading
``layers`` axis, and returns the port's parameter dictionary: the same names,
``blocks`` unstacked into one dictionary per layer.  Both packages then
compute the same function, which is what the parity tests rest on.

Takes numpy only and imports no JAX: the caller converts
(``jax.tree.map(np.asarray, values)``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.config import ModelConfig
from .models.modules import resolve_device


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


def from_jax_params(values: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """JAX value tree (numpy leaves) → repro_torch parameters."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    dev = resolve_device(device)
    known = {"embed", "final_norm", "lm_head", "blocks"}
    extra = set(values) - known
    if extra:
        raise ValueError(f"unexpected parameter groups {sorted(extra)}")
    out = {k: _convert(values[k], dev, dtype)
           for k in ("embed", "final_norm", "lm_head") if k in values}
    n_layers = max(cfg.num_layers, 1)
    lead = np.asarray(values["blocks"]["ln1"]).shape[0]
    if lead != n_layers:
        raise ValueError(f"blocks are stacked {lead} deep, the configuration "
                         f"has {n_layers} layers")
    out["blocks"] = [_convert(_layer(values["blocks"], l), dev, dtype)
                     for l in range(n_layers)]
    return out
