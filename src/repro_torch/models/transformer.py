"""Decoder-only LM, dense family (llama / qwen / chatglm).

Counterpart of ``repro.models.transformer``.  The JAX package stacks the
layers on a leading ``layers`` axis and runs them with ``lax.scan``; here
``params["blocks"]`` is a list with one dictionary per layer and the stack is
a Python loop.  The other families (moe, ssm, hybrid, vlm, audio) raise
``NotImplementedError`` until their slice is ported; ``loss_fn`` arrives with
the training slice.

Entry points:
  * ``init``              — dictionary of parameters from a seed.
  * ``init_decode_state`` — an empty decode state for a cache length.
  * ``prefill``           — runs the prompt, builds the decode state.
  * ``decode_step``       — one token for every sequence in the batch.

``init`` and ``init_decode_state`` default to ``device="cuda"`` and raise when
there is none; the CPU is used only when the caller names it.

The decode state is updated **in place**: ``decode_step`` writes the new K/V
into the buffers of the state it was given and returns a state that shares
them, so the old state must not be used again (the JAX package donates it to
the same effect).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .config import ModelConfig, ParallelConfig
from .layers import KVCache, apply_attn_block, init_attn_block
from .modules import (dense_init, embed_init, ones_init, resolve_device,
                      rms_norm)


class DecodeState(NamedTuple):
    """Everything carried between decode steps."""
    kv: Any            # KVCache of (L, B, S_cache, Hkv, hd) tensors
    ssm: Any           # SSM states (family not ported yet: always None)
    shared_kv: Any     # hybrid shared-block caches (not ported yet: None)
    cross_kv: Any      # enc-dec static cross caches (not ported yet: None)
    index: int         # next write position / number of tokens seen (host int)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet: only the dense decoder family is "
            "(ROADMAP.md, queue 1)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(seed_or_gen, cfg: ModelConfig, dtype=torch.float32,
         device="cuda") -> Dict[str, Any]:
    """Random parameters.  ``seed_or_gen`` is an int seed or a
    ``torch.Generator`` on ``device``."""
    _require_dense(cfg)
    dev = resolve_device(device)
    if isinstance(seed_or_gen, torch.Generator):
        gen = seed_or_gen
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed_or_gen))
    V = cfg.padded_vocab
    kw = dict(dtype=dtype, device=dev)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, V, cfg.d_model, **kw),
        "final_norm": ones_init((cfg.d_model,), **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, V), scale=0.02, **kw)
    params["blocks"] = [init_attn_block(gen, cfg, **kw)
                        for _ in range(max(cfg.num_layers, 1))]
    return params


# --------------------------------------------------------------------------
# shared forward machinery
# --------------------------------------------------------------------------

def _embed_inputs(params, cfg, batch):
    """Token embedding.  Returns (x, positions)."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, cache_len: int) -> int:
    return min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device="cuda") -> DecodeState:
    """Allocate the decode state for a given cache length."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, _cache_len(cfg, cache_len),
             cfg.n_kv_heads, cfg.head_dim)
    kv = KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
    return DecodeState(kv=kv, ssm=None, shared_kv=None, cross_kv=None, index=0)


def prefill(params, batch, cfg: ModelConfig, pcfg: Optional[ParallelConfig],
            cache_len: int) -> Tuple[torch.Tensor, DecodeState]:
    """Run the prompt; return (last-token logits (B, V), DecodeState)."""
    _require_dense(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    # every layer's cache is laid into one stacked buffer, as the JAX
    # package's scan stacks them
    shape = (cfg.num_layers, B, _cache_len(cfg, cache_len), cfg.n_kv_heads,
             cfg.head_dim)
    kv = KVCache(torch.empty(shape, dtype=x.dtype, device=x.device),
                 torch.empty(shape, dtype=x.dtype, device=x.device))
    for l, bp in enumerate(params["blocks"]):
        x, kvl = apply_attn_block(bp, cfg, pcfg, x, positions=positions,
                                  mode="prefill", cache_len=cache_len)
        kv.k[l].copy_(kvl.k)
        kv.v[l].copy_(kvl.v)
    state = DecodeState(kv=kv, ssm=None, shared_kv=None, cross_kv=None,
                        index=S)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    return logits[:, 0], state


def decode_step(params, tokens, state: DecodeState, cfg: ModelConfig,
                pcfg: Optional[ParallelConfig]
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: (B, 1) integer → logits (B, V).  Every row
    sits at position ``state.index``."""
    _require_dense(cfg)
    x = params["embed"][tokens]
    B = x.shape[0]
    positions = torch.full((B, 1), state.index, dtype=torch.int32,
                           device=x.device)
    for l, bp in enumerate(params["blocks"]):
        x, _ = apply_attn_block(
            bp, cfg, pcfg, x, positions=positions, mode="decode",
            cache=KVCache(state.kv.k[l], state.kv.v[l]),
            cache_index=state.index)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    return logits[:, 0], state._replace(index=state.index + 1)
