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
attention block and is converted as it is, as is the vlm's ``mm_proj``.
Audio (whisper) blocks carry ``ln_x`` and ``cross`` besides, and its
``encoder`` holds ``blocks`` stacked ``n_enc_layers`` deep (unstacked the same
way) and ``final_norm``.  A group the family does not have is refused as
unexpected.  Every level is walked the same way, however deep.  Both packages then
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
from .models.transformer import _require_ported


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


def _unstacked_groups(cfg: ModelConfig):
    return ("embed", "final_norm", "lm_head") + \
        {"hybrid": ("shared_attn",), "vlm": ("mm_proj",)}.get(cfg.family, ())


def _unstack(blocks, n_layers: int, what: str, device, dtype):
    leads = {a.shape[0] if a.ndim else 0 for a in _leaves(blocks)}
    if leads != {n_layers}:
        raise ValueError(f"{what} are stacked {sorted(leads)} deep, the "
                         f"configuration has {n_layers} layers")
    return [_convert(_layer(blocks, l), device, dtype) for l in range(n_layers)]


def from_jax_params(values: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """JAX value tree (numpy leaves) → repro_torch parameters."""
    _require_ported(cfg)
    dev = resolve_device(device)
    unstacked = _unstacked_groups(cfg)
    stacked = {"blocks"} | ({"encoder"} if cfg.family == "audio" else set())
    extra = set(values) - set(unstacked) - stacked
    if extra:
        raise ValueError(f"unexpected parameter groups {sorted(extra)}")
    missing = stacked - set(values)
    if missing:
        raise ValueError(f"missing parameter groups {sorted(missing)} of the "
                         f"{cfg.family} family")
    out = {k: _convert(values[k], dev, dtype) for k in unstacked if k in values}
    out["blocks"] = _unstack(values["blocks"], max(cfg.num_layers, 1), "blocks",
                             dev, dtype)
    if "encoder" in stacked:
        enc = values["encoder"]
        out["encoder"] = {
            "blocks": _unstack(enc["blocks"], max(cfg.n_enc_layers, 1),
                               "encoder blocks", dev, dtype),
            "final_norm": _convert(enc["final_norm"], dev, dtype)}
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
    """repro_torch parameters → JAX value tree (numpy leaves, ``blocks`` and
    the encoder's blocks stacked on a leading ``layers`` axis; bf16 tensors
    as float32 arrays)."""
    _require_ported(cfg)
    out = {k: _to_numpy_tree(v) for k, v in params.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = _stack([_to_numpy_tree(b) for b in params["blocks"]])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"blocks": _stack([_to_numpy_tree(b) for b in enc["blocks"]]),
                          "final_norm": _numpy(enc["final_norm"])}
    return out
