"""Transformer block layers shared by the attention families.

Counterpart of ``repro.models.layers``.  Each ``init_*`` returns a dictionary
of tensors with the JAX package's parameter names; each ``apply_*`` consumes
it.  Blocks are polymorphic over execution mode:

  * ``train``   — full-sequence forward (causal, or not for an encoder
                  block), no cache.
  * ``prefill`` — full-sequence forward that also emits the KV cache laid
                  out into a fixed ``cache_len`` buffer.
  * ``decode``  — single-token forward reading/updating the cache.

The KV cache of a layer is ``(k, v)`` of shape (B, cache_len, Hkv, hd); a
sliding-window layer uses a rolling buffer of size ``window``.

Cross-attention (a block with ``with_cross``, whisper's decoder): the queries
come from the decoder, the keys and values from the encoder's output, without
RoPE and without a mask.  In ``train`` and ``prefill`` it runs over the whole
encoder output (``prefill`` lays its K/V into the static cross cache, Sk
slots); at ``decode`` it reads that cache and writes nothing.

Two deliberate differences from the JAX file:

* On the ``train`` / ``prefill`` branch the JAX package calls
  ``dense_attention`` for S <= 512 and ``chunked_attention`` above (and for
  cross-attention); the port calls ``kernels.ops.attention``, so on the card
  every attention over a full sequence goes through the hand-written kernel:
  self-attention (a sliding-window layer's too, ``window=cfg.sliding_window``),
  an encoder block's (non-causal) and cross-attention (non-causal, Sq != Sk).
* ``_write_cache`` writes **in place** (JAX arrays are immutable, so
  ``dynamic_update_slice`` returns a new buffer); the returned tensor is the
  buffer that was passed in.

A block's FFN is the SwiGLU MLP or, for ``ffn="moe"``, the mixture of experts
(``models.moe``), whose router aux loss ``apply_attn_block`` returns.

Tensor parallelism: ``apply_attention``, ``apply_mlp`` and ``apply_attn_block``
take ``tp=``, a ``parallel.tp.TPContext`` (default None: one device, the same
code and launches as without it).  Under TP the sharded leaves (``wq`` /
``wk`` / ``wv`` / ``wo`` / ``bq`` / ``bk`` / ``bv``, ``w_gate`` / ``w_up`` /
``w_down``) are in the rows form over the TP axis and the norms whole; the
residual ``x`` is whole on every rank.  Each rank takes ``x`` through f
(``tp.copy``), projects its query and KV heads and runs ``ops.attention`` on
them (the flash kernel at its heads, the GQA group unchanged), or its MLP
columns, and multiplies by its rows of ``wo`` / ``w_down``; the partial sums
go through g (``tp.reduce``, the tree-reduce kernel) before the residual add.
``q_norm`` / ``k_norm``, which every rank reads, go through f too, so that
their gradient is summed by the same all-reduce on both meshes.  A KV cache
under TP holds the heads of the rows form (every head on a ``StackedMesh``,
this rank's on a ``DistMesh``); each rank reads and writes its heads' slice
of it in place.  A MoE block's FFN under TP is ``moe.moe_ffn(tp=)``: the router
once on the whole input, each rank's experts (or their ``mlp`` blocks).

Heads that do not divide the TP degree (``_attention_tp_padded``), placed as
the JAX package places them: a rank holds its block of the flattened ``Hq·hd``
/ ``Hkv·hd`` columns (2.5 query heads of qwen1.5-4b at ``model`` 8, half a KV
head of llama3.2-1b at ``model`` 16).  Each rank projects its columns; the
key and value columns are gathered, and the query columns where ``Hq`` does
not divide (one gather, ``tp.gather_parts``).  Each rank
then attends at its padded query heads (``tp.head_ranges``) with the KV heads
they read (the flash kernel on the card; a rank past the last head runs
none); the heads' outputs are gathered where ``Hq`` does not divide, so that
each rank multiplies its own block of ``wo``'s rows, then g.

The flash-decoding layout (``kv_seq=``, a ``parallel.tp.KVSeqContext``): the
self-attention cache's sequence in blocks over the ranks, every KV head on
every rank (``Ruleset.kv_cache_spec`` where the KV heads do not divide, or
where no data axis divides the batch).  A prefill keeps each rank's block of
the whole cache; a decode step gathers the whole query and the new K / V,
the rank that owns the slot writes it (``p % window`` for a rolling buffer),
and ``tp.flash_decode`` combines every rank's partial softmax statistics;
each rank then takes its block of the output's columns to its rows of
``wo``.  A cross-attention cache keeps its sequence whole, its heads in the
rows form where they divide and whole (replicated) where they do not.

Expert parallelism in the setups: ``apply_attn_blocks_ep`` runs one block for
the lanes of an EP group (``ep``, a ``parallel.tp.EPContext``), each lane's
attention on its own rows and parameters, then the MoE FFN of every lane
together (``moe.moe_ffn_lanes``).

Each ``init_*`` has a sibling ``*_axes(cfg, ...)`` that returns the same tree
with, in place of each tensor, the logical axis names of its dimensions (a
tuple of names, the JAX package's ``AxisNames``); ``transformer.param_axes``
assembles them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from .attention import apply_rope, decode_attention
from .modules import dense_init, ones_init, rms_norm, swiglu, zeros_init
from . import moe

Params = Dict[str, object]


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_cache, Hkv, hd)
    v: torch.Tensor


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, dtype=torch.float32,
                   device="cuda") -> Params:
    """QKV/O projections in flattened (d, H·hd) layout, as the JAX package."""
    d, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, (d, Hq * hd), **kw),
        "wk": dense_init(gen, (d, Hkv * hd), **kw),
        "wv": dense_init(gen, (d, Hkv * hd), **kw),
        "wo": dense_init(gen, (Hq * hd, d),
                         scale=1.0 / (d ** 0.5 * (2 * max(cfg.num_layers, 1)) ** 0.5),
                         **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((Hq * hd,), **kw)
        p["bk"] = zeros_init((Hkv * hd,), **kw)
        p["bv"] = zeros_init((Hkv * hd,), **kw)
    if cfg.qk_norm:
        p["q_norm"] = ones_init((hd,), **kw)
        p["k_norm"] = ones_init((hd,), **kw)
    return p


def attention_axes(cfg) -> Dict[str, Tuple[str, ...]]:
    """The logical axes of ``init_attention``'s tensors."""
    p = {"wq": ("embed", "qkv"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
         "wo": ("qkv", "embed")}
    if cfg.qkv_bias:
        p.update(bq=("qkv",), bk=("kv",), bv=("kv",))
    if cfg.qk_norm:
        p.update(q_norm=("null",), k_norm=("null",))
    return p


def _project_q(p, cfg, x):
    B, S = x.shape[:2]
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, -1, cfg.head_dim)          # a TP rank holds H / tp heads
    if "q_norm" in p:  # qwen3 qk-norm (per-head RMS)
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_qkv(p, cfg, x, kv_x, positions, *, use_rope: bool):
    Sk = kv_x.shape[1]
    hd = cfg.head_dim
    q = _project_q(p, cfg, x)
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(kv_x.shape[0], Sk, -1, hd)
    v = v.reshape(kv_x.shape[0], Sk, -1, hd)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and cfg.rope != "none":
        kv_positions = positions if kv_x is x else \
            torch.arange(Sk, device=x.device)[None].expand(kv_x.shape[0], Sk)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope)
        k = apply_rope(k, kv_positions, cfg.rope_theta, cfg.rope)
    return q, k, v


def apply_attention(p, cfg, pcfg, x, *, positions, mode: str = "train",
                    cache: Optional[KVCache] = None,
                    cache_index: Optional[int] = None,
                    cache_len: Optional[int] = None, kv_x=None,
                    causal: bool = True, window: int = 0, tp=None, kv_seq=None,
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Unified attention. Returns (out, new_cache).

    ``cache_index`` is a host integer (the JAX package traces it): the
    position the new token is written at.  With ``kv_x`` (cross-attention)
    the keys and values are projected from ``kv_x`` without RoPE; at
    ``decode`` they are read from ``cache``, the static cross cache, which is
    returned as it is.  With ``tp`` each rank runs its heads (``_attention_tp``).
    ``kv_seq``: the self-attention cache in the flash-decoding layout (see
    the module docstring).
    """
    if tp is not None:
        return _attention_tp(p, cfg, pcfg, x, tp, positions=positions, mode=mode, cache=cache,
                             cache_index=cache_index, cache_len=cache_len, kv_x=kv_x,
                             causal=causal, window=window, kv_seq=kv_seq)
    B, S = x.shape[:2]
    cross = kv_x is not None
    if mode == "decode" and cross:
        q = _project_q(p, cfg, x)
        out = decode_attention(q, cache.k, cache.v, cache.k.shape[1])
        return out.reshape(B, S, -1) @ p["wo"], cache

    new_cache = cache
    q, k, v = _project_qkv(p, cfg, x, kv_x if cross else x, positions,
                           use_rope=not cross)

    if mode == "decode" and kv_seq is not None:
        out = _decode_seq(q, k, v, cache, cache_index, window, kv_seq)
        new_cache = cache
    elif mode == "decode":
        # write new K/V at cache_index (rolling slot for SWA buffers)
        S_cache = cache.k.shape[1]
        write_pos = cache_index % S_cache if window else cache_index
        kc = _write_cache(cache.k, k, write_pos)
        vc = _write_cache(cache.v, v, write_pos)
        valid = min(cache_index + 1, S_cache)
        # positions past `valid` are masked to exactly 0 by decode_attention,
        # so reading only the valid prefix gives the same result
        out = decode_attention(q, kc[:, :valid], vc[:, :valid], valid)
        new_cache = KVCache(kc, vc)
    else:
        out = ops.attention(q, k, v, causal=causal, window=window)
        if mode == "prefill":
            new_cache = _build_cache(k, v, cache_len=cache_len or k.shape[1],
                                     window=window)
            if kv_seq is not None:
                new_cache = KVCache(kv_seq.place(new_cache.k), kv_seq.place(new_cache.v))
    B2, S2 = out.shape[:2]
    return out.reshape(B2, S2, -1) @ p["wo"], new_cache


def _decode_seq(q, k, v, cache, cache_index, window, kv_seq):
    """A decode step's self-attention over a cache in the flash-decoding
    layout: the new K / V (B, 1, Hkv, hd), whole, written at its slot
    (``p % length`` for a rolling buffer, else ``p``, clamped into the
    buffer as ``_write_cache`` clamps it), then ``kv_seq.attend`` over the
    ``min(p + 1, length)`` valid slots.  Returns (B, 1, Hq, hd)."""
    n = kv_seq.length
    pos = cache_index % n if window else min(cache_index, n - 1)
    kv_seq.write(cache.k, k, pos)
    kv_seq.write(cache.v, v, pos)
    return kv_seq.attend(q, cache.k, cache.v, min(cache_index + 1, n))


_TP_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _attention_tp(p, cfg, pcfg, x, tp, *, positions, mode, cache, cache_index, cache_len,
                  kv_x, causal, window, kv_seq=None):
    """``apply_attention`` of a TP group: each rank's heads in turn, on its
    rows of the sharded leaves; the rows' partial outputs summed by g.  A
    prefill's new cache holds the ranks' heads side by side (the rows form's
    heads); at decode each rank writes its slice of ``cache`` in place.
    Heads that do not divide the degree, and a cache in the flash-decoding
    layout, go to ``_attention_tp_padded``."""
    if (cfg.n_heads % tp.size or cfg.n_kv_heads % tp.size
            or (kv_seq is not None and kv_x is None)):
        return _attention_tp_padded(p, cfg, x, tp, positions=positions, mode=mode, cache=cache,
                                    cache_index=cache_index, cache_len=cache_len, kv_x=kv_x,
                                    causal=causal, window=window, kv_seq=kv_seq)
    cross = kv_x is not None
    xr = tp.copy(x)
    kvr = tp.copy(kv_x) if cross and mode != "decode" else xr if cross else None
    shared = {k: tp.copy(p[k]) for k in ("q_norm", "k_norm") if k in p}
    parts, caches = [], []
    for r in range(tp.rows):
        pr = {k: p[k][r] for k in _TP_ATTN if k in p}
        pr.update({k: v[r] for k, v in shared.items()})
        cr = None
        if cache is not None:
            h = cache.k.shape[2] // tp.rows
            cr = KVCache(cache.k.narrow(2, r * h, h), cache.v.narrow(2, r * h, h))
        out, new = apply_attention(pr, cfg, pcfg, xr[r], positions=positions, mode=mode,
                                   cache=cr, cache_index=cache_index, cache_len=cache_len,
                                   kv_x=None if kvr is None else kvr[r], causal=causal,
                                   window=window)
        parts.append(out)
        caches.append(new)
    new_cache = cache
    if mode == "prefill":
        new_cache = KVCache(torch.cat([c.k for c in caches], dim=2),
                            torch.cat([c.v for c in caches], dim=2))
    return tp.reduce(torch.stack(parts)), new_cache


def _columns(p, w, b, xr, r):
    """Row ``r``'s projection onto its block of ``p[w]``'s columns (+ bias)."""
    y = xr[r] @ p[w][r]
    return y + p[b][r] if b in p else y


def _shape_heads(t, cfg, norm, positions, use_rope):
    """(B, S, H, hd) heads: the per-head RMS norm ``norm`` (qk-norm, or
    None), then RoPE at ``positions`` where ``use_rope``."""
    if norm is not None:
        t = rms_norm(t, norm, cfg.norm_eps)
    if use_rope and cfg.rope != "none":
        t = apply_rope(t, positions, cfg.rope_theta, cfg.rope)
    return t


def _kv_for(k, v, a: int, b: int, group: int):
    """The KV heads that query heads ``a .. b-1`` read (head h reads h //
    ``group``), laid out for ``ops.attention``: a slice where they form a
    GQA layout of their own, else one KV head per query head."""
    idx = [h // group for h in range(a, b)]
    lo, n_kv, n = idx[0], idx[-1] - idx[0] + 1, b - a
    if n % n_kv == 0 and all(i == lo + j // (n // n_kv) for j, i in enumerate(idx)):
        return k[:, :, lo:lo + n_kv], v[:, :, lo:lo + n_kv]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _attention_tp_padded(p, cfg, x, tp, *, positions, mode, cache, cache_index, cache_len,
                         kv_x, causal, window, kv_seq):
    """``_attention_tp`` where the query or KV heads do not divide the
    degree, or the cache is in the flash-decoding layout (``kv_seq``; see
    the module docstring).  The key and value columns are always gathered
    (their heads do not divide, or the layout keeps every head); the query
    columns where ``Hq`` does not divide, or at a decode step over
    ``kv_seq``.  A cross-attention cache here holds every KV head.  Every
    rank runs every gather, also a rank past the last query head (its
    output, padding only, stays in the graph), so that the ranks of a
    ``DistMesh`` run their collectives in one order."""
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = x.shape[:2]
    cross = kv_x is not None
    decode = mode == "decode"
    if not cross and mode != "train" and kv_seq is None:
        raise ValueError(f"{cfg.name}: {Hkv} KV heads over {tp.size} ranks of {tp.axis!r}: the "
                         f"decode cache takes the flash-decoding layout, pass kv_seq "
                         f"(parallel.tp.KVSeqContext; the setups make it from kv_cache_spec)")
    seq = decode and not cross                      # flash decoding over kv_seq
    q_whole = seq or Hq % tp.size != 0
    xr = tp.copy(x)
    shared = {k: tp.copy(p[k]) for k in ("q_norm", "k_norm") if k in p}
    cols = [torch.stack([_columns(p, "wq", "bq", xr, r) for r in range(tp.rows)])]
    if not (cross and decode):
        src = tp.copy(kv_x) if cross else xr
        cols += [torch.stack([_columns(p, w, b, src, r) for r in range(tp.rows)])
                 for w, b in (("wk", "bk"), ("wv", "bv"))]
    if q_whole:
        cols = tp.gather_parts(cols)
    elif len(cols) > 1:
        cols[1:] = tp.gather_parts(cols[1:])
    Sk = kv_x.shape[1] if cross else S

    def heads(t, r, whole, n_seq):
        return (tp.whole_row(t[r]) if whole else t[r]).reshape(B, n_seq, -1, hd)

    outs, kept, out = [], None, None
    for r, (a, b) in enumerate(tp.head_ranges(Hq)):
        q = heads(cols[0], r, q_whole, S)
        if not seq:
            q = q[:, :, a:b] if q_whole else q
        q = _shape_heads(q, cfg, shared["q_norm"][r] if "q_norm" in shared else None,
                         positions, not cross)
        if cross and decode:
            k, v = cache.k, cache.v
        else:
            k, v = heads(cols[1], r, True, Sk), heads(cols[2], r, True, Sk)
            k = _shape_heads(k, cfg, shared["k_norm"][r] if "k_norm" in shared else None,
                             positions, not cross)
            kept = kept or (k, v)
        if seq:                 # no gradient: one row's whole query stands for every row's
            out = _decode_seq(q, k, v, cache, cache_index, window, kv_seq)
            break
        if b == a:              # a rank past the last query head
            outs.append(q)
            continue
        k, v = _kv_for(k, v, a, b, Hq // Hkv)
        outs.append(decode_attention(q, k, v, k.shape[1]) if decode else
                    ops.attention(q, k, v, causal=causal, window=window))
    new_cache = cache
    if mode == "prefill" and cross:
        new_cache = KVCache(kept[0].contiguous(), kept[1].contiguous())
    elif mode == "prefill":
        whole = _build_cache(*kept, cache_len=cache_len or S, window=window)
        new_cache = KVCache(kv_seq.place(whole.k), kv_seq.place(whole.v))
    cw = Hq * hd // tp.size
    if seq:
        flat = out.reshape(B, S, Hq * hd)
        parts = [flat[..., c * cw:(c + 1) * cw] @ p["wo"][r] for r, c in enumerate(tp.coords)]
    elif not q_whole:
        parts = [o.reshape(B, S, -1) @ p["wo"][r] for r, o in enumerate(outs)]
    else:
        hp = tp.padded(Hq)
        got = tp.gather(torch.stack([torch.nn.functional.pad(o, (0, 0, 0, hp - o.shape[2]))
                                     .reshape(B, S, hp * hd) for o in outs]))
        parts = [got[r][..., c * cw:(c + 1) * cw] @ p["wo"][r] for r, c in enumerate(tp.coords)]
    return tp.reduce(torch.stack(parts)), new_cache


def _write_cache(buf: torch.Tensor, kv: torch.Tensor, pos: int) -> torch.Tensor:
    """Write ``kv`` into ``buf`` at sequence position ``pos``, in place.

    Like ``lax.dynamic_update_slice``, the start is clamped so the update
    fits inside the buffer."""
    n = kv.shape[1]
    pos = max(0, min(int(pos), buf.shape[1] - n))
    buf[:, pos:pos + n] = kv.to(buf.dtype)
    return buf


def _build_cache(k, v, cache_len: int, window: int = 0) -> KVCache:
    """Lay prefill K/V into a fixed-size cache buffer.

    For sliding-window layers the buffer holds only the last ``window``
    positions (rolling semantics start aligned so that position p maps to
    slot p % window)."""
    B, S, H, hd = k.shape
    if window and window < cache_len:
        cache_len = window
    if S >= cache_len:
        # keep the last cache_len positions, aligned to their rolling slots
        start = S - cache_len
        ks, vs = k[:, start:], v[:, start:]
        if window:
            shift = start % cache_len
            ks = torch.roll(ks, shift, dims=1)
            vs = torch.roll(vs, shift, dims=1)
        return KVCache(ks.contiguous(), vs.contiguous())
    kc = k.new_zeros((B, cache_len, H, hd))
    vc = v.new_zeros((B, cache_len, H, hd))
    kc[:, :S] = k
    vc[:, :S] = v
    return KVCache(kc, vc)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, dtype=torch.float32,
             device="cuda") -> Params:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": dense_init(gen, (d, f), **kw),
        "w_up": dense_init(gen, (d, f), **kw),
        "w_down": dense_init(gen, (f, d),
                             scale=1.0 / (f ** 0.5 * (2 * max(cfg.num_layers, 1)) ** 0.5),
                             **kw),
    }


def mlp_axes(cfg) -> Dict[str, Tuple[str, ...]]:
    """The logical axes of ``init_mlp``'s tensors."""
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def apply_mlp(p, x, tp=None):
    """The SwiGLU MLP; with ``tp`` each rank's columns of ``w_gate`` /
    ``w_up`` and rows of ``w_down`` in turn, the partials summed by g."""
    if tp is None:
        return swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]
    xr = tp.copy(x)
    return tp.reduce(torch.stack([
        swiglu(xr[r] @ p["w_gate"][r], xr[r] @ p["w_up"][r]) @ p["w_down"][r]
        for r in range(tp.rows)]))


# --------------------------------------------------------------------------
# full block (pre-norm residual)
# --------------------------------------------------------------------------

def init_attn_block(gen: torch.Generator, cfg, dtype=torch.float32,
                    device="cuda", with_cross: bool = False,
                    ffn: str = "mlp") -> Params:
    kw = dict(dtype=dtype, device=device)
    p = {
        "ln1": ones_init((cfg.d_model,), **kw),
        "attn": init_attention(gen, cfg, **kw),
        "ln2": ones_init((cfg.d_model,), **kw),
    }
    if with_cross:
        p["ln_x"] = ones_init((cfg.d_model,), **kw)
        p["cross"] = init_attention(gen, cfg, **kw)
    p["ffn"] = (moe.init_moe if ffn == "moe" else init_mlp)(gen, cfg, **kw)
    return p


def attn_block_axes(cfg, with_cross: bool = False, ffn: str = "mlp") -> Params:
    """The logical axes of ``init_attn_block``'s tensors."""
    p: Params = {"ln1": ("embed",), "attn": attention_axes(cfg), "ln2": ("embed",)}
    if with_cross:
        p["ln_x"] = ("embed",)
        p["cross"] = attention_axes(cfg)
    p["ffn"] = (moe.moe_axes if ffn == "moe" else mlp_axes)(cfg)
    return p


def apply_attn_block(p, cfg, pcfg, x, *, positions, mode="train",
                     cache: Optional[KVCache] = None,
                     cache_index: Optional[int] = None,
                     cache_len: Optional[int] = None,
                     cross_cache: Optional[KVCache] = None, enc_out=None,
                     causal=True, tp=None, kv_seq=None):
    """Returns (x, new_cache, new_cross_cache, aux_loss), the JAX package's
    4-tuple.  A block with cross-attention reads ``enc_out`` (train, prefill;
    prefill returns the new cross cache) or ``cross_cache`` (decode; returned
    as it is); aux_loss is the MoE router's (an fp32 scalar, 0 for an MLP
    block).  ``tp``: the block of a TP group; ``kv_seq``: its self-attention
    cache in the flash-decoding layout."""
    h, new_cache = apply_attention(
        p["attn"], cfg, pcfg, rms_norm(x, p["ln1"], cfg.norm_eps),
        positions=positions, mode=mode, cache=cache, cache_index=cache_index,
        cache_len=cache_len, causal=causal, window=cfg.sliding_window, tp=tp,
        kv_seq=kv_seq)
    x = x + h
    new_cross = cross_cache
    if "cross" in p:
        xq = rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":
            hx, _ = apply_attention(p["cross"], cfg, pcfg, xq, positions=positions,
                                    mode="decode", cache=cross_cache, kv_x=x, tp=tp)
        else:
            hx, new_cross = apply_attention(
                p["cross"], cfg, pcfg, xq, positions=positions, mode=mode,
                cache_len=enc_out.shape[1], kv_x=enc_out, causal=False, tp=tp)
        x = x + hx
    y = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts and "router" in p["ffn"]:
        ff, aux = moe.moe_ffn(p["ffn"], y, cfg, tp=tp)
    else:
        ff = apply_mlp(p["ffn"], y, tp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff, new_cache, new_cross, aux


def apply_attn_blocks_ep(ps, cfg, pcfg, xs, *, positions, mode="train", caches=None,
                         cache_index: Optional[int] = None,
                         cache_len: Optional[int] = None, tp=None, ep=None, kv_seq=None):
    """One MoE block for the lanes of an expert-parallel group: ``ps`` each
    lane's parameters of the block (the expert leaves one joint tensor, see
    ``moe.moe_ffn_lanes``), ``xs`` each lane's residual (b, S, d), ``caches``
    each lane's ``KVCache`` (decode).  Each lane's attention runs on its own
    rows (under ``tp`` at its TP ranks' heads), then the FFN of every lane
    together.  Returns (the lanes' residuals, their new caches, aux (lanes,))."""
    hs, ys, new = [], [], []
    for r, p in enumerate(ps):
        h, c = apply_attention(
            p["attn"], cfg, pcfg, rms_norm(xs[r], p["ln1"], cfg.norm_eps),
            positions=positions, mode=mode, cache=None if caches is None else caches[r],
            cache_index=cache_index, cache_len=cache_len, window=cfg.sliding_window, tp=tp,
            kv_seq=kv_seq)
        x = xs[r] + h
        hs.append(x)
        ys.append(rms_norm(x, p["ln2"], cfg.norm_eps))
        new.append(c)
    ff, aux = moe.moe_ffn_lanes([p["ffn"] for p in ps], ys, cfg, ep=ep, tp=tp)
    return [x + f for x, f in zip(hs, ff)], new, aux
