"""The LM of every family: the dense family (llama / qwen / chatglm), the
mixture-of-experts family (mixtral / arctic), the attention-free SSM stack
(mamba2), the hybrid (zamba2), the VLM (llava) and the audio encoder/decoder
(whisper).

Counterpart of ``repro.models.transformer``.  The JAX package stacks the
layers on a leading ``layers`` axis and runs them with ``lax.scan``; here
``params["blocks"]`` is a list with one dictionary per layer and the stack is
a Python loop.  ``loss_fn`` trains every family; on a CUDA tensor its
gradient goes through the flash-attention and SSD-scan backward kernels.  A
MoE block is an attention block whose FFN is ``models.moe.moe_ffn``; its
router aux loss is summed over the layers into ``loss_fn``'s ``aux_loss``.

VLM (llava): ``params["mm_proj"]`` (d, d) projects the batch's precomputed
``patch_embeds`` (B, P, d) into a prefix of the token embeddings; positions
run over P + S, the labels of the patch positions are masked, and a prefill's
``index`` counts the patches.  Without ``patch_embeds`` the model is a text LM.

Audio (whisper): ``params["encoder"]`` (``models.whisper``) encodes the
batch's ``frames`` (B, enc_seq, d) through ``enc_fn(params, batch)``, which
``loss_fn`` and ``prefill`` take as the JAX functions do
(``parallel.steps._enc_fn`` makes it); every decoder block cross-attends to
the encoder's output, and the decode state keeps each layer's static cross
cache in ``cross_kv``.  Without ``enc_fn`` they raise a ``ValueError``.

Hybrid (zamba2) structure, as in the JAX package: ``num_layers`` Mamba2
blocks; after every ``attn_every`` of them, one *shared* attention block
(``params["shared_attn"]``, a single unstacked set of weights) applied
``num_layers / attn_every`` times, each application with its own KV slice.

Entry points:
  * ``init``              — dictionary of parameters from a seed.
  * ``param_axes``        — the logical axis names of every parameter.
  * ``loss_fn``           — causal LM loss of a batch.
  * ``init_decode_state`` — an empty decode state for a cache length.
  * ``prefill``           — runs the prompt, builds the decode state.
  * ``decode_step``       — one token for every sequence in the batch.

``init`` and ``init_decode_state`` default to ``device="cuda"`` and raise when
there is none; the CPU is used only when the caller names it.

``loss_fn``, ``prefill`` and ``decode_step`` take ``layer_constrain=``, as the
JAX functions do: a function of one block's parameters, applied to each block
of ``params["blocks"]`` right before the block runs (inside its
``_maybe_remat`` region, so that a recompute applies it again).  It defaults
to the identity; ``parallel.steps``'s FSDP setups pass one that gathers the
block's shards.

``loss_fn``, ``prefill``, ``decode_step`` (and ``models.whisper.encode``) take
``tp=``, a ``parallel.tp.TPContext`` (every family; default None, one
device).  Under TP the sharded leaves are in the rows form
over the TP axis (``parallel.steps``' setups place them): the embedding's
vocab rows and an untied head's columns too.  The lookup is vocab-parallel
(``tp.embed``), the head product column-parallel (each rank's ``(.., V /
tp)`` logits), the loss the vocab-parallel cross-entropy; ``prefill`` and
``decode_step`` return the logits in the rows form ``(R, B, V / tp)`` for the
setup to gather, and keep the heads of the rows form in the decode state (a
Mamba2 layer's SSM heads and conv channels too: ``models.ssm.mamba2_forward(
tp=)``; the hybrid's shared block runs as an attention block of the group).
``mm_proj``, the norms and a MoE block's router are whole on every rank.

``loss_fn``, ``prefill`` and ``decode_step`` take ``ep=``, a
``parallel.tp.EPContext`` (the moe family; the setups' expert parallelism):
the lanes of an EP group run together.  Then ``params`` is a list with one
tree per lane (each lane's own copies of the leaves the lanes share; the
expert leaves one joint tensor in every tree), ``layer_constrain`` a list
with one hook per lane (or one hook for every lane), the batch's tensors
(lanes, b, ...), ``loss_weight`` (lanes,).  ``loss_fn`` returns the sum of the lanes' totals and each lane's
metrics; ``prefill`` the logits (lanes, b, V) (under ``tp`` (lanes, R, b,
V / tp)) and one decode state with the lanes' rows one after another, which
``decode_step`` takes with tokens (lanes, b, 1).

The decode state is updated **in place**: ``decode_step`` writes the new K/V,
SSM states and conv lags into the buffers of the state it was given and
returns a state that shares them, so the old state must not be used again
(the JAX package donates it to the same effect).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from .config import ModelConfig, ParallelConfig
from .layers import (KVCache, apply_attn_block, apply_attn_blocks_ep, attn_block_axes,
                     init_attn_block)
from .modules import (dense_init, embed_init, ones_init, resolve_device,
                      rms_norm, softmax_cross_entropy, stack_axes)
from .ssm import SSMState, init_mamba2, init_ssm_state, mamba2_axes, mamba2_forward
from .whisper import encoder_axes, init_encoder

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class DecodeState(NamedTuple):
    """Everything carried between decode steps."""
    kv: Any            # dense / moe: KVCache of (L, B, S_cache, Hkv, hd) tensors
    ssm: Any           # ssm / hybrid: SSMState of (L, ...) stacked tensors
    shared_kv: Any     # hybrid: KVCache of (groups, B, S_cache, Hkv, hd)
    cross_kv: Any      # audio: KVCache of (L, B, enc_seq, Hkv, hd), static
    index: int         # next write position / number of tokens seen (host int)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"unknown model family {cfg.family!r} ({cfg.name}); the port "
            f"runs {', '.join(PORTED_FAMILIES)}")
    if cfg.family == "hybrid" and (cfg.attn_every < 1 or
                                   cfg.num_layers % cfg.attn_every):
        raise ValueError(f"hybrid: num_layers {cfg.num_layers} must be a "
                         f"multiple of attn_every {cfg.attn_every}")


def _is_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _shared_after(cfg: ModelConfig, layer: int) -> Optional[int]:
    """Hybrid: the shared block's application (its KV slice) that follows
    Mamba2 layer ``layer``, or None."""
    if cfg.family == "hybrid" and (layer + 1) % cfg.attn_every == 0:
        return layer // cfg.attn_every
    return None


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(seed_or_gen, cfg: ModelConfig, dtype=torch.float32,
         device="cuda") -> Dict[str, Any]:
    """Random parameters.  ``seed_or_gen`` is an int seed or a
    ``torch.Generator`` on ``device``.  On ``device="meta"`` the tree holds
    shapes and dtypes only (the setups' ``param_shapes``, as the JAX package
    gets them from ``jax.eval_shape``); the seed is not read there."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None                          # nothing is drawn on the meta device
    elif isinstance(seed_or_gen, torch.Generator):
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
    if _is_ssm(cfg):
        params["blocks"] = [{"ln": ones_init((cfg.d_model,), **kw),
                             "ssm": init_mamba2(gen, cfg, **kw)}
                            for _ in range(max(cfg.num_layers, 1))]
        if cfg.family == "hybrid":
            params["shared_attn"] = init_attn_block(gen, cfg, **kw)
    else:
        ffn = "moe" if cfg.n_experts else "mlp"
        params["blocks"] = [init_attn_block(gen, cfg, ffn=ffn,
                                            with_cross=cfg.family == "audio", **kw)
                            for _ in range(max(cfg.num_layers, 1))]
    if cfg.family == "vlm":
        params["mm_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), **kw)
    if cfg.family == "audio":
        params["encoder"] = init_encoder(gen, cfg, **kw)
    return params


def param_axes(cfg: ModelConfig, stacked: bool = True) -> Dict[str, Any]:
    """The logical axis names of every parameter ``init`` creates, a tuple of
    names per tensor, in ``init``'s tree.  ``stacked=True`` (the default)
    gives the JAX layout, what ``split(init(...))[1]`` gives there: ``blocks``
    (and whisper's ``encoder.blocks``) one dictionary whose leaves lead with
    ``"layers"``.  ``stacked=False`` gives the port's own layout: ``blocks`` a
    list with one dictionary per layer, without ``"layers"``."""
    _require_ported(cfg)
    axes: Dict[str, Any] = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if _is_ssm(cfg):
        def block():
            return {"ln": ("embed",), "ssm": mamba2_axes(cfg)}
    else:
        def block():
            return attn_block_axes(cfg, with_cross=cfg.family == "audio",
                                   ffn="moe" if cfg.n_experts else "mlp")
    n = max(cfg.num_layers, 1)
    axes["blocks"] = stack_axes(block()) if stacked else [block() for _ in range(n)]
    if cfg.family == "hybrid":
        axes["shared_attn"] = attn_block_axes(cfg)
    if cfg.family == "vlm":
        axes["mm_proj"] = ("embed", "embed_out")
    if cfg.family == "audio":
        axes["encoder"] = encoder_axes(cfg, stacked)
    return axes


# --------------------------------------------------------------------------
# shared forward machinery
# --------------------------------------------------------------------------

def _lookup(params, tokens, tp):
    """The token embedding: vocab-parallel under ``tp``."""
    return params["embed"][tokens] if tp is None else tp.embed(params["embed"], tokens)


def _embed_inputs(params, cfg, batch, tp=None):
    """Token (+ patch) embedding.  Returns (x, positions)."""
    tokens = batch["tokens"]
    x = _lookup(params, tokens, tp)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype) @ params["mm_proj"]
        x = torch.cat([pe, x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _encode(params, batch, cfg, enc_fn):
    """The encoder's output (audio), or None."""
    if cfg.family != "audio":
        return None
    if enc_fn is None:
        raise ValueError(f"{cfg.name} is an encoder/decoder: pass enc_fn, which "
                         f"encodes batch['frames'] (parallel.steps._enc_fn); "
                         f"without the encoder there is nothing to cross-attend to")
    return enc_fn(params, batch)


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg, x, tp):
    """``x @ head``; under ``tp`` each rank's vocab columns, the rows form
    ``(R, ..., V / tp)`` (x through f: every rank reads it)."""
    if tp is None:
        return x @ _head(params, cfg)
    xr = tp.copy(x)
    if cfg.tie_embeddings:
        return torch.stack([xr[r] @ params["embed"][r].T for r in range(tp.rows)])
    return torch.stack([xr[r] @ params["lm_head"][r] for r in range(tp.rows)])


def _require_ep(cfg, ep):
    if cfg.family != "moe":
        raise ValueError(f"expert parallelism over {ep.axis!r} needs the moe family, "
                         f"not {cfg.family} ({cfg.name})")


def _identity(bp):
    return bp


def _maybe_remat(fn, pcfg: ParallelConfig):
    """``pcfg.remat`` "block" or "full": ``fn`` under non-reentrant activation
    checkpointing, which keeps its inputs and recomputes the rest in the
    backward.  The JAX package's "block" keeps the outputs of products without
    batch dimensions besides; ``torch.utils.checkpoint`` has no such policy,
    so "block" and "full" are the same here.  "none": ``fn`` itself."""
    if pcfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(fn, *args,
                                                            use_reentrant=False)


# --------------------------------------------------------------------------
# training loss
# --------------------------------------------------------------------------

def loss_fn(params, batch, cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
            enc_fn=None, loss_weight=None, layer_constrain=_identity, tp=None, ep=None):
    """Causal LM loss.  batch: tokens (B, S) and labels (B, S) integer
    tensors (-1 = masked), plus ``patch_embeds`` (vlm) or ``frames`` (audio,
    encoded by ``enc_fn``).  Returns ``(total, {"loss", "aux_loss",
    "tokens"})`` as fp32 scalars; ``total`` is what the gradient is taken of,
    the metrics are detached from the graph.
    On a CUDA tensor every self-attention goes through the flash-attention
    forward and backward kernels (``kernels.ops.attention``), every Mamba2
    scan through the SSD-scan forward and backward kernels
    (``kernels.ops.ssd``).  The ssm and hybrid families run the Mamba2 stack
    in ``_ssm_stack``'s block order without a decode state (the hybrid's
    shared block after every ``attn_every`` layers), each block under
    ``_maybe_remat``, as the JAX package's ``_scan_blocks(mode="train")``.
    The MoE blocks' router aux losses are summed over the layers and enter
    ``total = loss + cfg.router_aux_weight * aux``; with ``loss_weight`` (a
    scalar), ``total = loss * loss_weight + cfg.router_aux_weight * aux``: a
    data-parallel rank weighs its shard's mean by its share of the labelled
    tokens (``parallel.steps.make_train_setup``).  With ``tp`` the loss is
    the vocab-parallel cross-entropy of each rank's logits, the same on
    every rank.  With ``ep`` the lanes of an EP group (see the module
    docstring): the total is the sum of the lanes', the metrics (lanes,)."""
    _require_ported(cfg)
    pcfg = pcfg or ParallelConfig()
    if ep is not None:
        return _loss_fn_ep(params, batch, cfg, pcfg, loss_weight, layer_constrain, tp, ep)
    x, positions = _embed_inputs(params, cfg, batch, tp)
    enc_out = _encode(params, batch, cfg, enc_fn)

    def attn(h, bp, enc_out=None, lc=_identity):
        out = apply_attn_block(lc(bp), cfg, pcfg, h, positions=positions, mode="train",
                               enc_out=enc_out, tp=tp)
        return out[0], out[3]
    attn = _maybe_remat(attn, pcfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _is_ssm(cfg):
        def mamba(h, bp):
            bp = layer_constrain(bp)
            return h + mamba2_forward(bp["ssm"], rms_norm(h, bp["ln"], cfg.norm_eps),
                                      cfg, tp=tp)
        mamba = _maybe_remat(mamba, pcfg)
        for l, bp in enumerate(params["blocks"]):
            x = mamba(x, bp)
            if _shared_after(cfg, l) is not None:
                # the shared block lies outside params["blocks"]: the setups
                # place (under fsdp gather) it once a call, not by the hook
                x, a = attn(x, params["shared_attn"])
                aux = aux + a
    else:
        for bp in params["blocks"]:
            x, a = attn(x, bp, enc_out, layer_constrain)
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x, tp)
    labels = batch["labels"]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        # image positions don't predict tokens
        P = batch["patch_embeds"].shape[1]
        labels = torch.cat([labels.new_full((labels.shape[0], P), -1), labels], dim=1)
    if tp is None:
        loss, count = softmax_cross_entropy(logits, labels, cfg.vocab_size)
    else:
        loss, count = tp.cross_entropy(logits, labels, cfg.vocab_size)
    weighted = loss if loss_weight is None else loss * loss_weight
    total = weighted + cfg.router_aux_weight * aux
    return total, {"loss": loss.detach(), "aux_loss": aux.detach(), "tokens": count}


def _lane_hooks(layer_constrain, n):
    """Each lane's hook: ``layer_constrain`` itself when it is a list, else
    the one hook (the identity by default) for every lane."""
    return layer_constrain if isinstance(layer_constrain, list) else [layer_constrain] * n


def _lane_inputs(lanes, tokens, tp):
    """Each lane's embedding of its (b, S) tokens, and the positions."""
    xs = [_lookup(lane, t, tp) for lane, t in zip(lanes, tokens)]
    b, S = xs[0].shape[:2]
    return xs, torch.arange(S, dtype=torch.int32, device=xs[0].device)[None].expand(b, S)


def _loss_fn_ep(lanes, batch, cfg, pcfg, loss_weight, layer_constrain, tp, ep):
    """``loss_fn`` of the lanes of an EP group: each lane's embedding, then
    every block with the lanes together (``apply_attn_blocks_ep``, under
    ``_maybe_remat``), then each lane's head and loss."""
    _require_ep(cfg, ep)
    R = len(lanes)
    lcs = _lane_hooks(layer_constrain, R)
    xs, positions = _lane_inputs(lanes, batch["tokens"], tp)

    def blocks(hs, bps):
        out = apply_attn_blocks_ep([lc(bp) for lc, bp in zip(lcs, bps)], cfg, pcfg, hs,
                                   positions=positions, mode="train", tp=tp, ep=ep)
        return out[0], out[2]
    blocks = _maybe_remat(blocks, pcfg)
    aux = torch.zeros(R, dtype=torch.float32, device=xs[0].device)
    for l in range(len(lanes[0]["blocks"])):
        xs, a = blocks(xs, [lane["blocks"][l] for lane in lanes])
        aux = aux + a
    total, losses, counts = 0.0, [], []
    for r, lane in enumerate(lanes):
        x = rms_norm(xs[r], lane["final_norm"], cfg.norm_eps)
        logits = _logits(lane, cfg, x, tp)
        labels = batch["labels"][r]
        if tp is None:
            loss, count = softmax_cross_entropy(logits, labels, cfg.vocab_size)
        else:
            loss, count = tp.cross_entropy(logits, labels, cfg.vocab_size)
        weighted = loss if loss_weight is None else loss * loss_weight[r]
        total = total + weighted + cfg.router_aux_weight * aux[r]
        losses.append(loss.detach())
        counts.append(count)
    return total, {"loss": torch.stack(losses), "aux_loss": aux.detach(),
                   "tokens": torch.stack(counts)}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, cache_len: int) -> int:
    return min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device="cuda") -> DecodeState:
    """Allocate the decode state for a given cache length."""
    _require_ported(cfg)
    dev = resolve_device(device)
    return _state_buffers(cfg, batch, cache_len, dtype, dev)


def _kv_buffers(cfg, n, batch, cache_len, dtype, device, tp=None, kv_seq=None) -> KVCache:
    """K and V buffers of ``n`` stacked caches, (n, B, S_cache, Hkv, hd);
    with ``tp`` the rows form's KV heads where they divide the degree, every
    head where they do not; with ``kv_seq`` every head and the layout's
    slots (``rows * block``)."""
    kv_heads = cfg.n_kv_heads
    if tp is not None and kv_seq is None and cfg.n_kv_heads % tp.size == 0:
        kv_heads = tp.heads(cfg.n_kv_heads)
    slots = kv_seq.rows * kv_seq.block if kv_seq is not None else _cache_len(cfg, cache_len)
    shape = (n, batch, slots, kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _state_buffers(cfg, batch, cache_len, dtype, device, tp=None, kv_seq=None) -> DecodeState:
    """The zeroed decode state of the family: every layer's cache or state
    in one stacked buffer, as the JAX package's scan stacks them (SSM states
    in fp32, the rest in ``dtype``); with ``tp`` (a ``TPContext``) the rows
    form's KV heads, SSM heads and conv channels; with ``kv_seq`` the self
    caches in the flash-decoding layout."""
    L = cfg.num_layers
    kv = ssm = shared = cross = None
    if _is_ssm(cfg):
        one = init_ssm_state(cfg, batch, dtype, device=device, tp=tp)
        ssm = SSMState(*(t.new_zeros((L, *t.shape)) for t in one))
        if cfg.family == "hybrid":
            shared = _kv_buffers(cfg, L // cfg.attn_every, batch, cache_len,
                                 dtype, device, tp, kv_seq)
    else:
        kv = _kv_buffers(cfg, L, batch, cache_len, dtype, device, tp, kv_seq)
        if cfg.family == "audio":
            cross = _kv_buffers(cfg, L, batch, cfg.enc_seq, dtype, device, tp)
    return DecodeState(kv=kv, ssm=ssm, shared_kv=shared, cross_kv=cross,
                       index=0)


def _ssm_stack(params, cfg, pcfg, x, positions, ssm: SSMState,
               shared: Optional[KVCache], *, mode: str, cache_len=None,
               cache_index=None, layer_constrain=_identity, tp=None, kv_seq=None):
    """The Mamba2 stack (and the hybrid's shared block), writing each
    layer's SSM state, conv lag and shared-block KV slice into the stacked
    buffers in place.  Returns the residual stream.  ``layer_constrain`` is
    applied to each Mamba2 block, not to the shared block (the setups place
    it once a call).  ``tp``: each block of a TP group, the buffers in the
    rows form's heads and channels; ``kv_seq``: the shared block's caches
    in the flash-decoding layout."""
    for l, bp in enumerate(params["blocks"]):
        bp = layer_constrain(bp)
        st = SSMState(ssm.h[l], ssm.conv[l]) if mode == "decode" else None
        out, new = mamba2_forward(bp["ssm"], rms_norm(x, bp["ln"], cfg.norm_eps),
                                  cfg, state=st, return_state=True, tp=tp)
        x = x + out
        ssm.h[l].copy_(new.h)
        ssm.conv[l].copy_(new.conv)
        g = _shared_after(cfg, l)
        if g is None:
            continue
        if mode == "decode":
            x = apply_attn_block(
                params["shared_attn"], cfg, pcfg, x, positions=positions,
                mode="decode", cache=KVCache(shared.k[g], shared.v[g]),
                cache_index=cache_index, tp=tp, kv_seq=kv_seq)[0]
        else:
            x, kvg, _, _ = apply_attn_block(
                params["shared_attn"], cfg, pcfg, x, positions=positions,
                mode="prefill", cache_len=cache_len, tp=tp, kv_seq=kv_seq)
            shared.k[g].copy_(kvg.k)
            shared.v[g].copy_(kvg.v)
    return x


def prefill(params, batch, cfg: ModelConfig, pcfg: Optional[ParallelConfig],
            cache_len: int, enc_fn=None, layer_constrain=_identity, tp=None, ep=None,
            kv_seq=None) -> Tuple[torch.Tensor, DecodeState]:
    """Run the prompt (after the patches, for a vlm batch with
    ``patch_embeds``; against the encoded ``frames`` for audio, through
    ``enc_fn``); return (last-token logits (B, V), DecodeState).  The state's
    ``index`` counts the patches too.  With ``tp`` the logits are the rows
    form (R, B, V / tp) and the caches hold the rows form's KV heads.  With
    ``ep`` the lanes of an EP group (see the module docstring).  With
    ``kv_seq`` the self caches in the flash-decoding layout."""
    _require_ported(cfg)
    if ep is not None:
        return _serve_ep(params, batch["tokens"], None, cfg, pcfg, layer_constrain, tp, ep,
                         cache_len=cache_len, kv_seq=kv_seq)
    x, positions = _embed_inputs(params, cfg, batch, tp)
    enc_out = _encode(params, batch, cfg, enc_fn)
    B, S = x.shape[:2]
    state = _state_buffers(cfg, B, cache_len, x.dtype, x.device, tp,
                           kv_seq)._replace(index=S)
    if _is_ssm(cfg):
        x = _ssm_stack(params, cfg, pcfg, x, positions, state.ssm,
                       state.shared_kv, mode="prefill", cache_len=cache_len,
                       layer_constrain=layer_constrain, tp=tp, kv_seq=kv_seq)
    else:
        for l, bp in enumerate(params["blocks"]):
            x, kvl, xkvl, _ = apply_attn_block(layer_constrain(bp), cfg, pcfg, x,
                                               positions=positions, mode="prefill",
                                               cache_len=cache_len, enc_out=enc_out, tp=tp,
                                               kv_seq=kv_seq)
            state.kv.k[l].copy_(kvl.k)
            state.kv.v[l].copy_(kvl.v)
            if xkvl is not None:
                state.cross_kv.k[l].copy_(xkvl.k)
                state.cross_kv.v[l].copy_(xkvl.v)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x, tp)
    return logits[..., 0, :], state


def decode_step(params, tokens, state: DecodeState, cfg: ModelConfig,
                pcfg: Optional[ParallelConfig], layer_constrain=_identity, tp=None,
                ep=None, kv_seq=None) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: (B, 1) integer → logits (B, V) (with ``tp``
    the rows form (R, B, V / tp)).  Every row sits at position
    ``state.index``.  With ``ep`` the lanes of an EP group (see the module
    docstring); with ``kv_seq`` the self caches in the flash-decoding
    layout (``prefill``'s)."""
    _require_ported(cfg)
    if ep is not None:
        return _serve_ep(params, tokens, state, cfg, pcfg, layer_constrain, tp, ep,
                         kv_seq=kv_seq)
    x = _lookup(params, tokens, tp)
    B = x.shape[0]
    positions = torch.full((B, 1), state.index, dtype=torch.int32,
                           device=x.device)
    if _is_ssm(cfg):
        x = _ssm_stack(params, cfg, pcfg, x, positions, state.ssm,
                       state.shared_kv, mode="decode", cache_index=state.index,
                       layer_constrain=layer_constrain, tp=tp, kv_seq=kv_seq)
    else:
        for l, bp in enumerate(params["blocks"]):
            cross = (KVCache(state.cross_kv.k[l], state.cross_kv.v[l])
                     if state.cross_kv is not None else None)
            x = apply_attn_block(
                layer_constrain(bp), cfg, pcfg, x, positions=positions, mode="decode",
                cache=KVCache(state.kv.k[l], state.kv.v[l]),
                cache_index=state.index, cross_cache=cross, tp=tp, kv_seq=kv_seq)[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x, tp)
    return logits[..., 0, :], state._replace(index=state.index + 1)


def _serve_ep(lanes, tokens, state, cfg, pcfg, layer_constrain, tp, ep, cache_len=None,
              kv_seq=None):
    """``prefill`` (``state`` None) or ``decode_step`` of the lanes of an EP
    group: tokens (lanes, b, S); each lane reads and writes its rows of the
    decode state (lane r rows r·b ...), the blocks run with the lanes
    together.  Returns (logits (lanes, ...), state)."""
    _require_ep(cfg, ep)
    R = len(lanes)
    lcs = _lane_hooks(layer_constrain, R)
    xs, positions = _lane_inputs(lanes, tokens, tp)
    b, S = xs[0].shape[:2]
    decode = state is not None
    if decode:
        positions = torch.full((b, 1), state.index, dtype=torch.int32, device=xs[0].device)
    else:
        state = _state_buffers(cfg, R * b, cache_len, xs[0].dtype, xs[0].device,
                               tp, kv_seq)._replace(index=S)
    for l in range(len(lanes[0]["blocks"])):
        caches = ([KVCache(state.kv.k[l].narrow(0, r * b, b), state.kv.v[l].narrow(0, r * b, b))
                   for r in range(R)] if decode else None)
        xs, new, _ = apply_attn_blocks_ep(
            [lc(lane["blocks"][l]) for lc, lane in zip(lcs, lanes)], cfg, pcfg, xs,
            positions=positions, mode="decode" if decode else "prefill", caches=caches,
            cache_index=state.index if decode else None, cache_len=cache_len, tp=tp, ep=ep,
            kv_seq=kv_seq)
        if not decode:
            for r, kv in enumerate(new):
                state.kv.k[l, r * b:(r + 1) * b].copy_(kv.k)
                state.kv.v[l, r * b:(r + 1) * b].copy_(kv.v)
    logits = torch.stack([
        _logits(lane, cfg, rms_norm(x[:, -1:], lane["final_norm"], cfg.norm_eps), tp)[..., 0, :]
        for lane, x in zip(lanes, xs)])
    return logits, state._replace(index=state.index + 1) if decode else state
