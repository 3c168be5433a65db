"""Flash-attention forward: the wrapper of the hand-written CUDA kernel and,
beside it, the plain PyTorch version of the same arithmetic.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).
The kernel's source is ``csrc/flash_attention.cu``; the note at its top says
what it replaces, what bounds it on an H100 and what its design does about it.

* ``flash_attention(q, k, v, causal=, scale=)`` launches the kernel.  It
  takes CUDA tensors only and raises on anything the kernel does not take; it
  never falls back to the plain version.  ``flash_attention.launches`` counts
  the launches.
* ``flash_attention_plain`` is blocked online-softmax attention in tensor
  ops: the oracle the kernel is held against on the card, and what
  ``ops.attention`` takes for a tensor that lies on the CPU.

Layout ``(B, S, H, hd)`` as in the JAX package.  Unlike the Pallas kernel,
which wants equal head counts (``ops.attention`` repeats K/V first), both
functions here read KV head ``h // (Hq // Hkv)`` for query head ``h``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build
from ..models.attention import NEG_INF, matmul_f32, repeat_kv

HEAD_DIMS = (64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)

_fn = None


def _kernel_fn():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
                       [ctypes.c_longlong] * 12 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int):
    if window:
        raise NotImplementedError(
            "the flash-attention kernel has no sliding window (neither has "
            "the Pallas kernel it replaces); window must be 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention launches a CUDA kernel: {name} "
                             f"lies on {t.device}; for a CPU tensor call "
                             "flash_attention_plain (ops.attention does)")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, hd), got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must share dtype and device")
        # 16-byte rows: what the fp32 kernel's vector loads and the bf16
        # kernel's TMA descriptors (address and strides multiples of 16 bytes) need
        vec = 16 // t.element_size()
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned "
                             f"(strides {t.stride()}, offset {t.storage_offset()})")
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
                    window: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd), CUDA, fp32 or bf16.

    Returns (B, Sq, Hq, hd) in q.dtype.  Launches on the current stream and
    does not synchronise.
    """
    _check(q, k, v, window)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 float(scale), int(bool(causal)),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        why = " (cuTensorMapEncodeTiled refused a TMA descriptor)" if err == -3 else ""
        raise RuntimeError(f"flash_attention_fwd failed to launch (code {err}{why}) "
                           f"for q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128
                          ) -> torch.Tensor:
    """The kernel's arithmetic in tensor ops, on any device.

    Blocks of ``block_q`` x ``block_k``; per kv block: scores in fp32, mask
    as ``where(mask, s, -1e30)``, running max ``m``, denominator ``l`` and
    accumulator in fp32, ``p`` cast to v's dtype for the second product;
    finalise ``acc / max(l, 1e-30)``.  With a causal mask the kv loop stops at
    the diagonal, as the kernel's does.
    """
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != Hq:
        k = repeat_kv(k, Hq // Hkv)
        v = repeat_kv(v, Hq // Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))      # (B,H,S,hd)
    out = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
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
        k_end = min(Sk, q0 + nq) if causal else Sk
        for k0 in range(0, k_end, block_k):
            kb = kh[:, :, k0:k0 + block_k]
            vb = vh[:, :, k0:k0 + block_k]
            s = matmul_f32(qb, kb.transpose(-1, -2)) * scale
            if causal:
                k_pos = k0 + torch.arange(kb.shape[2], device=q.device)
                s = torch.where(k_pos[None, :] <= q_pos[:, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + matmul_f32(p.to(vb.dtype), vb)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q0 + nq] = o.to(q.dtype)
    return out.permute(0, 2, 1, 3)
