"""Whisper-style encoder (the audio family).

Counterpart of ``repro.models.whisper``.  The conv / mel frontend is a stub, as
in the JAX package: the batch carries precomputed frame embeddings
``frames: (B, enc_seq, d_model)``.  The encoder is a stack of ``n_enc_layers``
non-causal attention blocks (``params["encoder"]["blocks"]``, one dictionary
per layer, as the port keeps every stack) and a final RMSNorm; the decoder is
``models.transformer``'s stack with cross-attention in every block.  On a
CUDA tensor each encoder block's attention goes through the flash-attention
kernel with ``causal=False`` (``kernels.ops.attention``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .config import ParallelConfig
from .layers import apply_attn_block, attn_block_axes, init_attn_block
from .modules import ones_init, rms_norm, stack_axes


def init_encoder(gen: torch.Generator, cfg, dtype=torch.float32,
                 device="cuda") -> Dict[str, Any]:
    """``n_enc_layers`` plain attention blocks and the final norm.  Their
    ``wo`` / ``w_down`` init scale reads ``cfg.num_layers`` (the decoder's
    depth), as the reference's does."""
    kw = dict(dtype=dtype, device=device)
    return {"blocks": [init_attn_block(gen, cfg, **kw)
                       for _ in range(max(cfg.n_enc_layers, 1))],
            "final_norm": ones_init((cfg.d_model,), **kw)}


def encoder_axes(cfg, stacked: bool = True) -> Dict[str, Any]:
    """The logical axes of ``init_encoder``'s tensors: ``blocks`` stacked with
    a leading ``layers`` name (the JAX layout), or with ``stacked=False`` a
    list of one block's axes per layer (the port's)."""
    n = max(cfg.n_enc_layers, 1)
    return {"blocks": (stack_axes(attn_block_axes(cfg)) if stacked
                       else [attn_block_axes(cfg) for _ in range(n)]),
            "final_norm": ("embed",)}


def encode(params, batch, cfg, pcfg=None, layer_constrain=lambda bp: bp,
           tp=None) -> torch.Tensor:
    """frames (B, enc_seq, d_model) → encoder hidden states, each block under
    ``transformer._maybe_remat``, RoPE positions ``0..enc_seq-1``.
    ``layer_constrain`` is applied to each encoder block's parameters inside
    that region, as ``transformer.loss_fn`` applies it to the decoder's;
    ``tp`` goes to each block (tensor parallelism, ``models.layers``)."""
    from .transformer import _maybe_remat    # transformer imports this module
    pcfg = pcfg or ParallelConfig()
    enc = params["encoder"]
    x = batch["frames"]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    def run(h, bp):
        return apply_attn_block(layer_constrain(bp), cfg, pcfg, h, positions=positions,
                                mode="train", causal=False, tp=tp)[0]
    run = _maybe_remat(run, pcfg)
    for bp in enc["blocks"]:
        x = run(x, bp)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)
