"""Flash attention, forward and backward: the wrappers of the hand-written
CUDA kernels and, beside each, the plain PyTorch version of the same
arithmetic.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel,
which has no backward: the JAX package trains through attention that JAX
differentiates).  The kernels' sources are ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``; the note at the top of each says what it
replaces, what bounds it on an H100 and what its design does about it.

* ``flash_attention(q, k, v, causal=, scale=, window=)`` launches the forward kernel,
  and with ``return_lse=True`` also has it write each row's log-sum-exp for
  the backward.  ``flash_attention_bwd(q, k, v, o, do, lse, ...)`` launches
  the backward kernel and returns ``(dq, dk, dv)``.  Both take CUDA tensors
  only and raise on anything the kernels do not take; they never fall back to
  the plain versions.  ``flash_attention.launches`` and
  ``flash_attention_bwd.launches`` count the launches.
* ``flash_attention_plain`` (blocked online-softmax attention) and
  ``flash_attention_bwd_plain`` (the backward recomputing P block by block
  from the log-sum-exp) are the same arithmetic in tensor ops: the oracles
  the kernels are held against on the card, and what ``ops.attention`` takes
  for a tensor that lies on the CPU.
* ``FlashAttention`` is the ``torch.autograd.Function`` that joins a forward
  to its backward, kernel to kernel or plain to plain.  ``ops.attention``
  sends every call whose inputs need a gradient there, and every other call
  to the forward alone, which then writes no log-sum-exp.
* ``flash_fwd_work`` / ``flash_bwd_work`` are a call's work, (FLOPs, bytes):
  the products over the (query, key) pairs it computes (``attention_pairs``)
  against every input read once and every output written once.  The bounds
  of ``chip_smoke.py`` and ``launch.roofline.count_cost`` read them
  (``kernels.work``).

Layout ``(B, S, H, hd)`` as in the JAX package.  Unlike the Pallas kernel,
which wants equal head counts (``ops.attention`` repeats K/V first), both
functions here read KV head ``h // (Hq // Hkv)`` for query head ``h``.

A sliding window (``window > 0``, mixtral's): the query at position i sees the
keys j with i - window < j <= i, the JAX package's ``_block_mask``
(``src/repro/models/attention.py:83-92``).  Every function here skips the key
tiles that lie wholly before a query tile's window and masks the edge tiles.
The Pallas kernel has no window; the plain versions take one with any
``causal`` (the model's oracle permits it), the kernels only with
``causal=True``: no model path of the reference passes a window without the
causal mask, as none passes ``q_offset`` or ``kv_len``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, work
from ..models.attention import NEG_INF, matmul_f32, repeat_kv

HEAD_DIMS = (64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)

_fn = None        # flash_attention_fwd, bound at first use
_bwd_fn = None    # flash_attention_bwd, bound at first use


def _bind(fn, n_ptr: int, n_strides: int):
    fn.restype = ctypes.c_int     # ... scale, causal, window, is_bf16, stream
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 +
                   [ctypes.c_longlong] * n_strides +
                   [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    return fn


def _kernel_fn():
    """The forward's C entry point, built and bound at first use."""
    global _fn
    if _fn is None:     # q, k, v, o, lse; strides of q, k, v, o
        _fn = _bind(build.load("flash_attention").flash_attention_fwd, 5, 12)
    return _fn


def _bwd_kernel_fn():
    """The backward's C entry point, built and bound at first use."""
    global _bwd_fn
    if _bwd_fn is None:  # q, k, v, o, do, lse, delta, dq, dk, dv; 8 tensors' strides
        _bwd_fn = _bind(build.load("flash_attention_bwd").flash_attention_bwd, 10, 24)
    return _bwd_fn


def _rows_aligned(t: torch.Tensor) -> bool:
    """16-byte rows: what the fp32 kernels' vector loads, the bf16 kernels' TMA
    descriptors (address and strides multiples of 16 bytes), the D pass's and
    hd 80's 16-byte loads need."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and not any(s % vec for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    if not _rows_aligned(t):
        raise ValueError(f"{name}: rows must be 16-byte aligned "
                         f"(strides {t.stride()}, offset {t.storage_offset()})")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int):
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError(
            "the flash-attention kernels take a sliding window only with "
            "causal=True: no model path passes a window without the causal "
            "mask (flash_attention_plain takes one)")
    if window and q.dim() == k.dim() == 4 and q.shape[1] > k.shape[1]:
        raise ValueError(f"a sliding window needs Sq <= Sk (a query past the last "
                         f"key could see none), got Sq {q.shape[1]}, Sk {k.shape[1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention launches a CUDA kernel: {name} "
                             f"lies on {t.device}; for a CPU tensor call "
                             "flash_attention_plain (ops.attention does)")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, hd), got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must share dtype and device")
        _check_rows(name, t)
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, Sq, Hq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(B, Sq, Hq, k.shape[1], k.shape[2]) < 1 or Hq % k.shape[2]:
        raise ValueError(f"need Hq a multiple of Hkv and no empty dimension: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: int = 0, return_lse: bool = False):
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd), CUDA, fp32 or bf16.

    Returns (B, Sq, Hq, hd) in q.dtype and, with ``return_lse``, also each
    row's log-sum-exp of the scaled scores, fp32 (B, Hq, Sq).  ``window > 0``
    (with ``causal``): query i sees keys i - window < j <= i.  Launches on
    the current stream and does not synchronise.
    """
    _check(q, k, v, causal, window)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 B, Sq, Sk, Hq, Hkv, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 float(scale), int(bool(causal)), int(window),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        why = " (cuTensorMapEncodeTiled refused a TMA descriptor)" if err == -3 else ""
        raise RuntimeError(f"flash_attention_fwd failed to launch (code {err}{why}) "
                           f"for q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        window: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    cotangent ``do`` of its output ``o``, from the forward's log-sum-exp
    ``lse`` (fp32 (B, Hq, Sq)).  CUDA tensors; dk and dv are summed over the
    query heads of each KV group.  Launches on the current stream (three
    kernels: the row sums D, dK/dV, dQ) and does not synchronise.
    """
    _check(q, k, v, causal, window)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} "
                             f"{t.device} against {tuple(q.shape)} {q.dtype}")
    if not _rows_aligned(do):
        do = do.contiguous()          # a cotangent may come in any layout
    _check_rows("o", o)
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous fp32 {(B, Hq, Sq)} on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    # the D pass's output: D = rowsum(do * o), then lse * log2(e), each
    # (B, Hq, Sq rounded up to 128) so that the kernels copy whole 64-row tiles
    sqp = -(-Sq // 128) * 128
    delta = torch.empty(2 * B * Hq * sqp, dtype=torch.float32, device=q.device)
    fn = _bwd_kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
                 B, Sq, Sk, Hq, Hkv, hd,
                 *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]),
                 float(scale), int(bool(causal)), int(window),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        why = " (cuTensorMapEncodeTiled refused a TMA descriptor)" if err == -3 else ""
        raise RuntimeError(f"flash_attention_bwd failed to launch (code {err}{why}) "
                           f"for q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _kv_blocks(q0: int, nq: int, Sk: int, block_k: int, causal: bool,
               window: int) -> range:
    """Starts of the kv blocks a q block [q0, q0 + nq) visits: up to the
    diagonal if causal, from the block holding the first row's first key
    (q0 - window + 1) if windowed.  A block left out would add exactly 0."""
    k_end = min(Sk, q0 + nq) if causal else Sk
    k_start = max(0, q0 - window + 1) // block_k * block_k if window else 0
    return range(k_start, k_end, block_k)


def _mask(q_pos, k_pos, causal: bool, window: int):
    """(nq, nk) mask of allowed (query, key) pairs, or None: every pair."""
    ok = None
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
    if window:
        w = k_pos[None, :] > q_pos[:, None] - window
        ok = w if ok is None else ok & w
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128,
                          return_lse: bool = False, window: int = 0):
    """The kernel's arithmetic in tensor ops, on any device.

    Blocks of ``block_q`` x ``block_k``; per kv block: scores in fp32, mask
    as ``where(mask, s, -1e30)``, running max ``m``, denominator ``l`` and
    accumulator in fp32, ``p`` cast to v's dtype for the second product;
    finalise ``acc / max(l, 1e-30)``.  With a causal mask the kv loop stops at
    the diagonal, as the kernel's does; with a window it starts at the block
    holding the block's first row's first key.  With ``return_lse`` also
    returns ``m + log l`` per row, fp32 (B, Hq, Sq).  The output is laid out
    as the kernel writes it, (B, Sq, Hq, hd) contiguous, so that what the
    caller does with it (a reshape) moves the same bytes on either device.
    """
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != Hq:
        k = repeat_kv(k, Hq // Hkv)
        v = repeat_kv(v, Hq // Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))      # (B,H,S,hd)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    oh = out.permute(0, 2, 1, 3)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, block_q):
        qb = qh[:, :, q0:q0 + block_q]
        nq = qb.shape[2]
        q_pos = q0 + torch.arange(nq, device=q.device)
        m = torch.full((B, Hq, nq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hq, nq, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in _kv_blocks(q0, nq, Sk, block_k, causal, window):
            kb = kh[:, :, k0:k0 + block_k]
            vb = vh[:, :, k0:k0 + block_k]
            s = matmul_f32(qb, kb.transpose(-1, -2)) * scale
            ok = _mask(q_pos, k0 + torch.arange(kb.shape[2], device=q.device),
                       causal, window)
            if ok is not None:
                s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + matmul_f32(p.to(vb.dtype), vb)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        oh[:, :, q0:q0 + nq] = o.to(q.dtype)
        lse[:, :, q0:q0 + nq] = m + torch.log(l)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                              *, causal: bool = True, scale: Optional[float] = None,
                              block_q: int = 128, block_k: int = 128,
                              window: int = 0):
    """The backward kernel's arithmetic in tensor ops, on any device.

    ``D = rowsum(do * o)`` in fp32; per (q block, kv block), up to the
    diagonal if causal and from the window's first block if windowed:
    ``P = exp(s - lse)`` recomputed from fp32 scores and
    set to 0 where masked, ``dv += P^T do`` and ``dS = P * (do v^T - D)``,
    ``dq += dS k``, ``dk += dS^T q``, with P and dS rounded to the input dtype
    for those products and every sum in fp32; dq and dk are scaled at the
    end.  dk and dv are summed over the query heads of each KV group.
    Returns (dq, dk, dv) in the input dtype, each (B, S, H, hd) contiguous
    as the kernel writes them.
    """
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dt = q.dtype
    qh, oh, doh = (t.permute(0, 2, 1, 3) for t in (q, o, do))      # (B,Hq,Sq,hd)
    kh, vh = (repeat_kv(t, rep).permute(0, 2, 1, 3) for t in (k, v))
    delta = (doh.float() * oh.float()).sum(dim=-1)                   # (B,Hq,Sq)
    dq = torch.zeros((B, Hq, Sq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Hq, Sk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, block_q):
        qb, dob = qh[:, :, q0:q0 + block_q], doh[:, :, q0:q0 + block_q]
        nq = qb.shape[2]
        q_pos = q0 + torch.arange(nq, device=q.device)
        lse_b = lse[:, :, q0:q0 + nq, None]
        d_b = delta[:, :, q0:q0 + nq, None]
        for k0 in _kv_blocks(q0, nq, Sk, block_k, causal, window):
            kb, vb = kh[:, :, k0:k0 + block_k], vh[:, :, k0:k0 + block_k]
            s = matmul_f32(qb, kb.transpose(-1, -2)) * scale
            p = torch.exp(s - lse_b)
            ok = _mask(q_pos, k0 + torch.arange(kb.shape[2], device=q.device),
                       causal, window)
            if ok is not None:
                p = torch.where(ok, p, 0.0)
            dv[:, :, k0:k0 + block_k] += matmul_f32(p.to(dt).transpose(-1, -2), dob)
            ds = (p * (matmul_f32(dob, vb.transpose(-1, -2)) - d_b)).to(dt)
            dq[:, :, q0:q0 + nq] += matmul_f32(ds, kb)
            dk[:, :, k0:k0 + block_k] += matmul_f32(ds.transpose(-1, -2), qb)
    dk = dk.view(B, Hkv, rep, Sk, hd).sum(dim=2)
    dv = dv.view(B, Hkv, rep, Sk, hd).sum(dim=2)
    return ((dq * scale).to(dt).permute(0, 2, 1, 3).contiguous(),
            (dk * scale).to(dt).permute(0, 2, 1, 3).contiguous(),
            dv.to(dt).permute(0, 2, 1, 3).contiguous())


def window_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal windowed attention computes over S
    positions: query i sees min(i + 1, window) keys."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int = 0):
    """(query, key) pairs a call computes: with a window the pairs inside it
    (``window_pairs`` over Sq), causal half of Sq x Sk, else Sq x Sk."""
    if window:
        return window_pairs(Sq, window)
    if causal:
        return Sq * Sk / 2
    return Sq * Sk


def flash_fwd_work(q, k, v, out, lse=None, *, causal: bool = True, window: int = 0):
    """(FLOPs, bytes) of one forward: its two products over the pairs, 4 x B
    x Hq x pairs x hd, against q, k, v read once and the output (and the
    log-sum-exp, when written) written once."""
    B, Sq, Hq, hd = q.shape
    return (4 * B * Hq * attention_pairs(Sq, k.shape[1], causal, window) * hd,
            work.nbytes(q, k, v, out, lse))


def flash_bwd_work(q, k, v, o, do, lse, dq, dk, dv, *, causal: bool = True, window: int = 0):
    """(FLOPs, bytes) of one backward: five products (Q.K^T, dO.V^T, P^T.dO,
    dS^T.Q, dS.K), 2.5 times the forward's work over the same pairs, against
    q, k, v, o, dO and the log-sum-exp read once and dq, dk, dv written once
    (the kernels recompute two products for dQ: seven, which ``chip_smoke.py``
    bounds apart)."""
    B, Sq, Hq, hd = q.shape
    return (5 * 2 * B * Hq * attention_pairs(Sq, k.shape[1], causal, window) * hd,
            work.nbytes(q, k, v, o, do, lse, dq, dk, dv))


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward saves its output and the
    per-row log-sum-exp, the backward recomputes P from them.  ``kernel``
    chooses the CUDA kernels or the plain versions, for both directions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float], kernel: bool,
                window: int = 0):
        fwd = flash_attention if kernel else flash_attention_plain
        with work.muted():
            out, lse = fwd(q, k, v, causal=causal, scale=scale, return_lse=True,
                           window=window)
        work.report(flash_fwd_work, q, k, v, out, lse, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.kernel, ctx.window = causal, scale, kernel, window
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if ctx.kernel else flash_attention_bwd_plain
        with work.muted():
            dq, dk, dv = bwd(q, k, v, out, do, lse, causal=ctx.causal, scale=ctx.scale,
                             window=ctx.window)
        work.report(flash_bwd_work, q, k, v, out, do, lse, dq, dk, dv, causal=ctx.causal,
                    window=ctx.window)
        return dq, dk, dv, None, None, None, None
