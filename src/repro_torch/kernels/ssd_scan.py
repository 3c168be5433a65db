"""Mamba2 SSD chunked scan: the wrapper of the hand-written CUDA kernel and,
beside it, the plain PyTorch version of the same arithmetic.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel).  The
kernel's source is ``csrc/ssd_scan.cu``; the note at its top says what it
replaces, what bounds it on an H100 and what its design does about it.

* ``ssd_scan(x, dt, A, Bmat, Cmat, initial_state=, return_state=)`` launches
  the kernel.  It takes CUDA tensors only and raises on anything the kernel
  does not take; it never falls back to the plain version.
  ``ssd_scan.launches`` counts the launches.
* ``ssd_scan_plain`` is the chunked scan in tensor ops: a loop over chunks
  with the carried state, fp32 inside, y cast to x's dtype.  It is the
  oracle the kernel is held against on the card, and what ``ops.ssd`` takes
  for a tensor that lies on the CPU.
* The kernel has no backward yet (ROADMAP.md, K2-bwd with M3b), and writing
  into a fresh tensor through ``ctypes`` would cut the autograd graph without
  a word; so ``ssd_scan`` and ``ops.ssd`` raise (``refuse_grad``) when
  gradients are enabled and an input requires one.

Shapes as in the JAX package: x ``(B, S, H, hd)``, dt ``(B, S, H)`` (softplus
already applied), A ``(H,)`` (negative), B / C ``(B, S, G, N)`` with G
dividing H; y ``(B, S, H, hd)`` and the state ``(B, H, hd, N)`` in fp32.
Unlike the Pallas kernel, which starts from a zero state, drops the final one
and repeats B / C per head, both functions here take an initial state,
return the final one on request, and read group ``h // (H // G)`` for head
``h`` in place.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

CHUNK = 64                        # the kernel's compile-time chunk
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (8, 16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

_fn = None


def _kernel_fn():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        lib = build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 +
                       [ctypes.c_longlong] * 16 +
                       [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def _check(x, dt, A, Bmat, Cmat, initial_state):
    named = (("x", x), ("dt", dt), ("A", A), ("Bmat", Bmat), ("Cmat", Cmat))
    if initial_state is not None:
        named += (("initial_state", initial_state),)
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan launches a CUDA kernel: {name} lies on "
                             f"{t.device}; for a CPU tensor call ssd_scan_plain "
                             "(ops.ssd does)")
        if t.device != x.device:
            raise ValueError("all inputs must lie on one device")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bmat.dim() != 4 \
            or Cmat.dim() != 4:
        raise ValueError(f"need x (B,S,H,hd), dt (B,S,H), A (H,), B/C (B,S,G,N); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bmat.shape)}, {tuple(Cmat.shape)}")
    Bsz, S, H, hd = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    if Bmat.dtype != x.dtype or Cmat.dtype != x.dtype:
        raise ValueError("x, Bmat and Cmat must share one dtype")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("dt and A must be float32")
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) or \
            tuple(Bmat.shape[:2]) != (Bsz, S) or Cmat.shape != Bmat.shape:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bmat.shape)}, C {tuple(Cmat.shape)}")
    if min(Bsz, S, H, G) < 1 or H % G:
        raise ValueError(f"need G dividing H and no empty dimension: H {H}, G {G}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"state size {N} not supported {STATE_DIMS}")
    for name, t in (("x", x), ("Bmat", Bmat), ("Cmat", Cmat)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    if initial_state is not None:
        if tuple(initial_state.shape) != (Bsz, H, hd, N) or \
                initial_state.dtype != torch.float32 or \
                not initial_state.is_contiguous():
            raise ValueError(f"initial_state must be a contiguous float32 "
                             f"{(Bsz, H, hd, N)} tensor, got "
                             f"{tuple(initial_state.shape)} {initial_state.dtype}")


def refuse_grad(*tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need the scan's gradient: it has none yet."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            "the SSD scan has no backward yet: the SSD backward kernel "
            "(ROADMAP.md K2-bwd, with the SSM / hybrid training step M3b) is "
            "still to be ported; run the scan under torch.no_grad() or "
            "torch.inference_mode()")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, *,
             initial_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """CUDA tensors; x / B / C fp32 or bf16, dt and A fp32.

    Returns y ``(B, S, H, hd)`` in x's dtype, and the final state
    ``(B, H, hd, N)`` fp32 if ``return_state``.  Launches on the current
    stream and does not synchronise.  Raises if an input requires a gradient
    while gradients are enabled (``refuse_grad``).
    """
    refuse_grad(x, dt, A, Bmat, Cmat, initial_state)
    _check(x, dt, A, Bmat, Cmat, initial_state)
    Bsz, S, H, hd = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    y = torch.empty((Bsz, S, H, hd), dtype=x.dtype, device=x.device)
    final = (torch.empty((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(),
                 initial_state.data_ptr() if initial_state is not None else None,
                 y.data_ptr(), final.data_ptr() if final is not None else None,
                 Bsz, S, H, G, hd, N,
                 *x.stride()[:3], *dt.stride(), A.stride(0),
                 *Bmat.stride()[:3], *Cmat.stride()[:3], *y.stride()[:3],
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd failed to launch (code {err}) for x "
                           f"{tuple(x.shape)} B {tuple(Bmat.shape)} {x.dtype}")
    ssd_scan.launches += 1
    return (y, final) if return_state else y


ssd_scan.launches = 0


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """(..., Q) → (..., Q, Q) lower-triangular cumulative log-decay:
    segsum[i, j] = sum_{k=j+1..i} log_a[k] for i >= j, -inf otherwise, so
    that ``exp`` of it is the decay matrix L with exact zeros above the
    diagonal (the difference there is never exponentiated)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=log_a.device)
    mask = ii[:, None] >= ii[None, :]
    return diff.masked_fill(~mask, -math.inf)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor, *,
                   initial_state: Optional[torch.Tensor] = None,
                   return_state: bool = False, chunk: int = CHUNK):
    """The kernel's arithmetic in tensor ops, on any device.

    Per chunk of ``chunk`` tokens, in fp32: ``cs = cumsum(dt*A)``;
    ``M = (C.B^T) * exp(segsum(dt*A)) * dt_j`` (zero above the diagonal);
    ``y = M.x + (C.state^T) * exp(cs)``;
    ``state = exp(cs_last)*state + sum_q (x_q dt_q exp(cs_last - cs_q)) B_q^T``.
    A short last chunk needs no padding: the state after it is the state
    after token S-1.
    """
    Bsz, S, H, hd = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    f32 = torch.float32
    dev = x.device
    state = (torch.zeros((Bsz, H, hd, N), dtype=f32, device=dev)
             if initial_state is None else initial_state.to(f32).clone())
    Af = A.to(f32)
    y = torch.empty((Bsz, S, H, hd), dtype=x.dtype, device=dev)
    for s0 in range(0, S, chunk):
        xs = x[:, s0:s0 + chunk].to(f32)                          # (B,Q,H,hd)
        dts = dt[:, s0:s0 + chunk].to(f32).transpose(1, 2)        # (B,H,Q)
        Bh = Bmat[:, s0:s0 + chunk].to(f32).repeat_interleave(rep, dim=2)
        Ch = Cmat[:, s0:s0 + chunk].to(f32).repeat_interleave(rep, dim=2)
        Q = xs.shape[1]
        dA = dts * Af[None, :, None]                              # (B,H,Q)
        cs = torch.cumsum(dA, dim=-1)
        L = torch.exp(segsum(dA))                                 # (B,H,Q,Q)
        scores = torch.einsum("bihn,bjhn->bhij", Ch, Bh)
        M = scores * L * dts[:, :, None, :]
        y_intra = torch.einsum("bhij,bjhd->bihd", M, xs)
        y_inter = torch.einsum("bihn,bhdn->bihd", Ch, state) * \
            torch.exp(cs).transpose(1, 2)[..., None]
        y[:, s0:s0 + Q] = (y_intra + y_inter).to(x.dtype)
        w = dts * torch.exp(cs[..., -1:] - cs)                    # (B,H,Q)
        state = state * torch.exp(cs[..., -1])[..., None, None] + \
            torch.einsum("bhq,bqhd,bqhn->bhdn", w, xs, Bh)
    return (y, state) if return_state else y
