"""Attention in plain PyTorch: GQA with RoPE variants, sliding windows, a
blocked online-softmax implementation and the single-token decode path.

Counterpart of ``repro.models.attention``; layout ``(B, S, H, hd)`` at every
public function, as there.  ``dense_attention`` is the numerically trivial
oracle, ``chunked_attention`` carries ``window`` / ``q_offset`` / ``kv_len``,
and ``decode_attention`` reads a KV cache.  The hand-written CUDA kernel for
the prefill lives in ``repro_torch.kernels.flash_attention``; nothing here
launches it.

All softmax statistics are fp32; matrix products run in the input dtype with
fp32 results where the JAX package asks for them
(``preferred_element_type=float32``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str = "default") -> torch.Tensor:
    """Rotary embedding, rotate-half convention.

    x: (B, S, H, hd); positions: (B, S) absolute positions.  ``mode``:
    ``default`` rotates the full head_dim (pairs are (x[i], x[i+hd/2])),
    ``2d`` rotates only the first half of head_dim (chatglm), ``none`` is the
    identity.  cos / sin are computed in fp32 and cast to ``x.dtype`` before
    the multiply, as the JAX package does: in bf16 that is where the rounding
    happens.
    """
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot_dim = hd if mode == "default" else hd // 2
    half = rot_dim // 2
    freqs = rope_frequencies(rot_dim, theta, device=x.device)     # (half,)
    angles = positions.to(torch.float32)[..., None] * freqs       # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)            # (B,S,1,half)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1 = x[..., :half]
    x2 = x[..., half:rot_dim]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    if rot_dim == hd:
        return torch.cat([r1, r2], dim=-1)
    return torch.cat([r1, r2, x[..., rot_dim:]], dim=-1)


# --------------------------------------------------------------------------
# prefill / train attention
# --------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA → MHA: (B,S,Hkv,hd) → (B,S,Hkv·n_rep,hd); query head ``h`` reads
    KV head ``h // n_rep``."""
    if n_rep == 1:
        return k
    B, S, H, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, H, n_rep, hd) \
        .reshape(B, S, H * n_rep, hd)


def _allowed(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window: int, kv_len: int) -> torch.Tensor:
    """(Sq, Sk) boolean mask from absolute query / key positions."""
    ok = (k_pos < kv_len)[None, :].expand(q_pos.shape[0], -1)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result that was never rounded to the input
    dtype (the JAX package's ``preferred_element_type=float32``).  A product
    of two bf16 values is exact in fp32, so up-casting the operands gives
    just that."""
    return torch.matmul(a.float(), b.float())


def dense_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, scale=None):
    """Plain (materialized-scores) attention: the oracle for the blocked and
    the CUDA versions."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if k.shape[2] != H:
        k = repeat_kv(k, H // k.shape[2])
        v = repeat_kv(v, H // v.shape[2])
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_len = Sk if kv_len is None else kv_len
    s = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * scale
    ok = _allowed(q_offset + torch.arange(Sq, device=q.device),
                  torch.arange(Sk, device=q.device), causal, window, kv_len)
    s = s + torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype), v.permute(0, 2, 1, 3))      # (B,H,Sq,hd)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024,
                      q_offset: int = 0, kv_len: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax blocked attention, O(S·chunk) memory.

    q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd) with Hkv dividing H.  Returns
    (B, Sq, H, hd) in q.dtype.  Ragged tails are sliced, not padded: a
    padded key would be masked to ``exp(-1e30 - m) = 0`` anyway.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if k.shape[2] != H:
        k = repeat_kv(k, H // k.shape[2])
        v = repeat_kv(v, H // v.shape[2])
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_len = Sk if kv_len is None else kv_len
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)

    qh = q.permute(0, 2, 1, 3)                                    # (B,H,Sq,hd)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, q_chunk):
        qb = qh[:, :, q0:q0 + q_chunk]
        nq = qb.shape[2]
        q_pos = q_offset + q0 + torch.arange(nq, device=q.device)
        m = torch.full((B, H, nq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, nq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, nq, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Sk, k_chunk):
            kb = kh[:, :, k0:k0 + k_chunk]
            vb = vh[:, :, k0:k0 + k_chunk]
            k_pos = k0 + torch.arange(kb.shape[2], device=q.device)
            s = matmul_f32(qb, kb.transpose(-1, -2)) * scale
            ok = _allowed(q_pos, k_pos, causal, window, kv_len)
            s = s + torch.where(ok, 0.0, NEG_INF).to(torch.float32)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + matmul_f32(p.to(vb.dtype), vb)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q0 + nq] = o.to(q.dtype)
    return out.permute(0, 2, 1, 3)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_valid(pos: torch.Tensor, cache_len, window: int = 0) -> torch.Tensor:
    """(B|1, n) bool: which of the cache slots ``pos`` (n,) a decode step
    reads, for ``cache_len`` (int, scalar or (B,)) valid positions and an
    optional ``window``."""
    clen = torch.as_tensor(cache_len, device=pos.device).reshape(-1, 1)
    valid = pos[None, :] < clen                                   # (B|1, n)
    if window:
        valid = valid & (pos[None, :] >= clen - window)
    return valid


def decode_scores(q, k_cache, valid, scale: Optional[float] = None) -> torch.Tensor:
    """The fp32 scores (B, Hkv, group, n) of the single query ``q`` (B, 1,
    Hq, hd) against the cache slots ``k_cache`` (B, n, Hkv, hd), ``NEG_INF``
    where ``valid`` (B|1, n) is False.  The product runs in the cache dtype."""
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    # (B,Hkv,group,hd) x (B,Hkv,hd,n) -> (B,Hkv,group,n)
    s = torch.matmul(qg, k_cache.permute(0, 2, 3, 1)).float() * scale
    return torch.where(valid[:, None, None, :], s,
                       torch.tensor(NEG_INF, dtype=torch.float32, device=q.device))


def decode_values(p: torch.Tensor, denom: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """``(p / denom)`` cast to the cache dtype, times the values (B, n, Hkv,
    hd): (B, Hkv, group, hd) in the cache dtype."""
    return torch.matmul((p / denom).to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     scale: Optional[float] = None):
    """Single-token decode attention over a KV cache.

    q: (B, 1, Hq, hd); caches: (B, S, Hkv, hd); cache_len: int, scalar or
    (B,) count of valid cache positions (the new token's K/V already
    written).  Softmax in fp32; ``p / denom`` is cast to the cache dtype before
    the second product.  Both products run in the cache dtype, without an
    fp32 copy of the cache: for a bf16 cache the library product rounds its
    fp32 sum to bf16 on the way out, which the JAX package's
    ``preferred_element_type=float32`` does not.  The difference is one bf16
    rounding of each score and lies inside the bf16 tolerance of the tests;
    for an fp32 cache the two agree.  ``decode_scores`` and
    ``decode_values`` are its two products; ``parallel.tp.flash_decode``
    runs them on each rank's block of a cache whose sequence is split over
    ranks and sums the statistics between them.
    """
    B, _, Hq, hd = q.shape
    S = k_cache.shape[1]
    s = decode_scores(q, k_cache, decode_valid(torch.arange(S, device=q.device), cache_len,
                                               window), scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = decode_values(p, denom, v_cache).float()                # (B,Hkv,g,hd)
    return out.reshape(B, 1, Hq, hd).to(q.dtype)
