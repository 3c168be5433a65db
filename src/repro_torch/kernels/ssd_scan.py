"""Mamba2 SSD chunked scan, forward and backward: the wrappers of the
hand-written CUDA kernels and, beside each, the plain PyTorch version of the
same arithmetic.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel, which has
no backward: the JAX package trains through ``ssd_chunked``, which JAX
differentiates).  The kernels' sources are ``csrc/ssd_scan.cu`` and
``csrc/ssd_scan_bwd.cu``; the note at the top of each says what it replaces,
what bounds it on an H100 and what its design does about it.

* ``ssd_scan(x, dt, A, Bmat, Cmat, initial_state=, return_state=)`` launches
  the forward kernel; ``ssd_scan_bwd(x, dt, A, Bmat, Cmat, y_grad,
  initial_state=, final_state_grad=)`` launches the backward kernel and
  returns ``(dx, ddt, dA, dB, dC, dh0)``.  Both take CUDA tensors only and
  raise on anything the kernels do not take; they never fall back to the
  plain versions.  ``ssd_scan.launches`` and ``ssd_scan_bwd.launches`` count
  the launches.  ``ssd_scan`` writes a fresh tensor through ``ctypes``, which
  autograd cannot see through: a caller that needs a gradient goes through
  ``SSDScan`` (``ops.ssd`` does).
* ``ssd_scan_plain`` is the chunked scan in tensor ops: a loop over chunks
  with the carried state, fp32 inside, y cast to x's dtype.
  ``ssd_scan_bwd_plain`` is its gradient as an explicit reverse walk over the
  chunks in tensor ops (not autograd), fp32 inside.  They are the oracles
  the kernels are held against on the card, and what ``ops.ssd`` takes for a
  tensor that lies on the CPU.
* ``SSDScan`` is the ``torch.autograd.Function`` that joins a forward to its
  backward, kernel to kernel or plain to plain.
* ``ssd_fwd_work`` / ``ssd_bwd_work`` are a call's work, (FLOPs, bytes): the
  chunk-by-chunk products against every input read once and every output
  written once.  The bounds of ``chip_smoke.py`` and ``launch.roofline.
  count_cost`` read them (``kernels.work``).

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

from . import build, work

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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, *,
             initial_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """CUDA tensors; x / B / C fp32 or bf16, dt and A fp32.

    Returns y ``(B, S, H, hd)`` in x's dtype, and the final state
    ``(B, H, hd, N)`` fp32 if ``return_state``.  Launches on the current
    stream and does not synchronise.  The result has no gradient: for one,
    go through ``SSDScan``.
    """
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


def _advance(state, xs, dts, Bh, cs):
    """The state leaving a chunk, fp32: ``exp(cs_last) * state + sum_q
    (x_q dt_q exp(cs_last - cs_q)) B_q^T``, from the state entering it, the
    chunk's x ``(B,Q,H,hd)``, dt ``(B,H,Q)``, B per head ``(B,Q,H,N)`` and
    ``cs = cumsum(dt*A)`` ``(B,H,Q)``."""
    w = dts * torch.exp(cs[..., -1:] - cs)                        # (B,H,Q)
    return state * torch.exp(cs[..., -1])[..., None, None] + \
        torch.einsum("bhq,bqhd,bqhn->bhdn", w, xs, Bh)


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
        state = _advance(state, xs, dts, Bh, cs)
    return (y, state) if return_state else y


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

_bwd_fn = None


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address for the C interface; None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def _bwd_kernel_fn():
    """The backward's C entry point, built and bound at first use."""
    global _bwd_fn
    if _bwd_fn is None:   # 19 pointers (inputs, outputs, scratch); strides of x, dt, A, B, C, dy
        fn = build.load("ssd_scan_bwd").ssd_scan_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 +
                       [ctypes.c_longlong] * 16 + [ctypes.c_int, ctypes.c_void_p])
        _bwd_fn = fn
    return _bwd_fn


def bwd_heads_per_block(H: int, G: int) -> int:
    """k: how many heads of one group a block of the bf16 backward takes (the
    largest divisor of H / G up to 8); it sums their dB and dC itself."""
    rep = H // G
    return max(k for k in range(1, 9) if rep % k == 0)


def bwd_scratch(Bsz: int, S: int, H: int, hd: int, N: int, G: int, dtype: torch.dtype):
    """The backward's scratch as ``{name: (shape, dtype)}``: the states
    entering each chunk and their gradients, fp32 ``(2, B, H, nc, hd, N)``,
    in bf16 calls hi and lo bf16 planes ``(2, B, H, nc, 2, hd, N)`` (the same
    bytes); the partial dB and dC, fp32, of each head ``(2, B, S, H, N)``, in
    bf16 calls of each block of k heads ``(2, B, S, G, H / (G k), N)``; and
    the partial dA ``(B, nc, H)``."""
    nc = -(-S // CHUNK)
    f32 = torch.float32
    if dtype == torch.bfloat16:
        k = bwd_heads_per_block(H, G)
        return {"states": ((2, Bsz, H, nc, 2, hd, N), torch.bfloat16),
                "partial_bc": ((2, Bsz, S, G, H // (G * k), N), f32),
                "partial_a": ((Bsz, nc, H), f32)}
    return {"states": ((2, Bsz, H, nc, hd, N), f32),
            "partial_bc": ((2, Bsz, S, H, N), f32),
            "partial_a": ((Bsz, nc, H), f32)}


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bmat: torch.Tensor, Cmat: torch.Tensor, y_grad: torch.Tensor, *,
                 initial_state: Optional[torch.Tensor] = None,
                 final_state_grad: Optional[torch.Tensor] = None):
    """The gradient of ``ssd_scan`` (y and the final state) on CUDA tensors:
    ``(dx, ddt, dA, dB, dC, dh0)`` with dx, dB, dC in x's dtype, ddt, dA and
    dh0 in fp32 (dh0 None without an initial state).  ``y_grad`` is dy
    ``(B, S, H, hd)`` in x's dtype, ``final_state_grad`` the cotangent of the
    final state ``(B, H, hd, N)`` fp32 contiguous, or None for zero.  Takes
    what ``ssd_scan`` takes; allocates its outputs and its scratch
    (``bwd_scratch``) with ``torch.empty``.  Launches on the current stream
    and does not synchronise."""
    _check(x, dt, A, Bmat, Cmat, initial_state)
    Bsz, S, H, hd = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if not y_grad.is_cuda or y_grad.device != x.device or \
            tuple(y_grad.shape) != tuple(x.shape) or y_grad.dtype != x.dtype or \
            y_grad.stride(3) != 1:
        raise ValueError(f"y_grad must be a CUDA {x.dtype} tensor of x's shape "
                         f"{tuple(x.shape)} with a contiguous last dimension, got "
                         f"{tuple(y_grad.shape)} {y_grad.dtype} on {y_grad.device}")
    if final_state_grad is not None and (
            final_state_grad.device != x.device or
            tuple(final_state_grad.shape) != (Bsz, H, hd, N) or
            final_state_grad.dtype != torch.float32 or
            not final_state_grad.is_contiguous()):
        raise ValueError(f"final_state_grad must be a contiguous float32 "
                         f"{(Bsz, H, hd, N)} tensor on {x.device}, got "
                         f"{tuple(final_state_grad.shape)} {final_state_grad.dtype}")
    dev, f32 = x.device, torch.float32
    dx = torch.empty((Bsz, S, H, hd), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dh0 = (torch.empty((Bsz, H, hd, N), dtype=f32, device=dev)
           if initial_state is not None else None)
    states, partial_bc, partial_a = (
        torch.empty(shape, dtype=dtype, device=dev)
        for shape, dtype in bwd_scratch(Bsz, S, H, hd, N, G, x.dtype).values())
    fn = _bwd_kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), _ptr(initial_state), y_grad.data_ptr(),
                 _ptr(final_state_grad),
                 dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                 dC.data_ptr(), _ptr(dh0),
                 states[0].data_ptr(), states[1].data_ptr(), partial_bc[0].data_ptr(),
                 partial_bc[1].data_ptr(), partial_a.data_ptr(),
                 Bsz, S, H, G, hd, N, bwd_heads_per_block(H, G),
                 *x.stride()[:3], *dt.stride(), A.stride(0),
                 *Bmat.stride()[:3], *Cmat.stride()[:3], *y_grad.stride()[:3],
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd failed to launch (code {err}) for x "
                           f"{tuple(x.shape)} B {tuple(Bmat.shape)} {x.dtype}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dh0


ssd_scan_bwd.launches = 0


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bmat: torch.Tensor, Cmat: torch.Tensor, y_grad: torch.Tensor, *,
                       initial_state: Optional[torch.Tensor] = None,
                       final_state_grad: Optional[torch.Tensor] = None,
                       chunk: int = CHUNK):
    """The gradient of ``ssd_scan_plain`` as the kernel computes it, on any
    device: a forward walk for the state ``h_c`` entering each chunk, then a
    reverse walk carrying ``dh``, the gradient of the state leaving the
    chunk (``final_state_grad``, or zero, at the end).  Per chunk, per head,
    in fp32, with ``cs = cumsum(dt*A)``, ``L[i, j] = exp(cs_i - cs_j)`` for
    j <= i (else 0), ``w_j = dt_j exp(cs_last - cs_j)``:

    * ``dx_j = sum_i M_ij dy_i + w_j dh B_j`` with ``M = (C.B^T) L dt_j``;
    * ``dB_j = sum_i (dy_i.x_j) L_ij dt_j C_i + w_j dh^T x_j``;
    * ``dC_i = sum_j (dy_i.x_j) L_ij dt_j B_j + exp(cs_i) h_c^T dy_i``;
    * ``ddt_j`` = the direct terms ``sum_i (dy_i.x_j)(C_i.B_j) L_ij`` and
      ``exp(cs_last - cs_j) x_j^T dh B_j``, plus A times the reverse cumsum
      of ``dcs`` (the gradient through ``cs``); ``dA = sum dt * that
      reverse cumsum``;
    * ``dh <- exp(cs_last) dh + sum_i exp(cs_i) dy_i C_i^T``; after the
      first chunk it is dh0.

    dB and dC are summed over the heads of a group.  Returns ``(dx, ddt,
    dA, dB, dC, dh0)``: dx, dB, dC in x's dtype, the rest fp32, dh0 None
    without an initial state.
    """
    Bsz, S, H, hd = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    f32 = torch.float32
    dev = x.device
    Af = A.to(f32)
    starts = list(range(0, S, chunk))
    # forward walk: the state entering each chunk, as ssd_scan_plain carries it
    state = (torch.zeros((Bsz, H, hd, N), dtype=f32, device=dev)
             if initial_state is None else initial_state.to(f32))
    entering = []
    for s0 in starts:
        entering.append(state)
        dts = dt[:, s0:s0 + chunk].to(f32).transpose(1, 2)             # (B,H,Q)
        state = _advance(state, x[:, s0:s0 + chunk].to(f32), dts,
                         Bmat[:, s0:s0 + chunk].to(f32).repeat_interleave(rep, dim=2),
                         torch.cumsum(dts * Af[None, :, None], dim=-1))
    # reverse walk
    dh = (torch.zeros((Bsz, H, hd, N), dtype=f32, device=dev)
          if final_state_grad is None else final_state_grad.to(f32))
    dx = torch.empty((Bsz, S, H, hd), dtype=f32, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dBh = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    dCh = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    dA = torch.zeros((H,), dtype=f32, device=dev)
    for s0, hc in zip(reversed(starts), reversed(entering)):
        sl = slice(s0, s0 + chunk)
        xs, dys = x[:, sl].to(f32), y_grad[:, sl].to(f32)              # (B,Q,H,hd)
        dts = dt[:, sl].to(f32).transpose(1, 2)                        # (B,H,Q)
        Bh = Bmat[:, sl].to(f32).repeat_interleave(rep, dim=2)         # (B,Q,H,N)
        Ch = Cmat[:, sl].to(f32).repeat_interleave(rep, dim=2)
        a = dts * Af[None, :, None]
        cs = torch.cumsum(a, dim=-1)
        cl = cs[..., -1:]                                              # (B,H,1)
        L = torch.exp(segsum(a))                                       # (B,H,Q,Q)
        CB = torch.einsum("bihn,bjhn->bhij", Ch, Bh)
        DX = torch.einsum("bihd,bjhd->bhij", dys, xs)
        dtj = dts[:, :, None, :]
        M = CB * L * dtj
        Gd = DX * L * dtj
        Gm = CB * DX * L
        P = Gm * dtj
        w = dts * torch.exp(cl - cs)                                   # (B,H,Q)
        ecs = torch.exp(cs)
        wq = w.transpose(1, 2)[..., None]                              # (B,Q,H,1)
        BdH = torch.einsum("bjhn,bhdn->bjhd", Bh, dh)                  # dh B_j
        Ux = (xs * BdH).sum(-1).transpose(1, 2)                        # (B,H,Q)
        dx[:, sl] = torch.einsum("bhij,bihd->bjhd", M, dys) + wq * BdH
        dBh[:, sl] = torch.einsum("bhij,bihn->bjhn", Gd, Ch) + \
            wq * torch.einsum("bjhd,bhdn->bjhn", xs, dh)
        dC_inter = ecs.transpose(1, 2)[..., None] * torch.einsum("bihd,bhdn->bihn", dys, hc)
        dCh[:, sl] = torch.einsum("bhij,bjhn->bihn", Gd, Bh) + dC_inter
        U = w * Ux
        dcs = P.sum(-1) - P.sum(-2) + (dC_inter * Ch).sum(-1).transpose(1, 2) - U
        dcs[..., -1] += torch.exp(cl[..., 0]) * (dh * hc).sum((-2, -1)) + U.sum(-1)
        da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
        ddt[:, sl] = (Gm.sum(-2) + torch.exp(cl - cs) * Ux +
                      Af[None, :, None] * da).transpose(1, 2)
        dA += (dts * da).sum((0, 2))
        dh = dh * torch.exp(cl)[..., None] + \
            torch.einsum("bhi,bihd,bihn->bhdn", ecs, dys, Ch)
    dB = dBh.view(Bsz, S, G, rep, N).sum(3)
    dC = dCh.view(Bsz, S, G, rep, N).sum(3)
    return (dx.to(x.dtype), ddt, dA, dB.to(Bmat.dtype), dC.to(Cmat.dtype),
            dh if initial_state is not None else None)


def ssd_fwd_work(x, dt, A, Bmat, Cmat, initial_state, y, final_state):
    """(FLOPs, bytes) of one forward: the causal half of the two
    chunk-by-chunk products, then C.state^T and the state update, against x,
    dt, A, B, C (and the initial state) read once and y and the final state
    (when returned) written once."""
    Bsz, S, H, hd = x.shape
    N = Bmat.shape[3]
    flops = 0
    for s0 in range(0, S, CHUNK):
        q = min(CHUNK, S - s0)
        flops += q * (q + 1) * (N + hd) + 4 * q * hd * N
    return (flops * Bsz * H,
            work.nbytes(x, dt, A, Bmat, Cmat, y, final_state, initial_state))


def ssd_bwd_work(x, dt, A, Bmat, Cmat, initial_state, y_grad, grads):
    """(FLOPs, bytes) of one backward: the causal halves of C.B^T and dy.x^T
    and of the three chunk-by-chunk products of dx, dB and dC, and five (hd x
    N) products a chunk (dh.B, x^T.dh, dy.h_c, the state and the gradient
    chains), against x, dt, A, B, C, the initial state and dy read once and
    every gradient (``grads``, None where not asked) written once.  The
    kernel's scratch (``bwd_scratch``) belongs to its design, not to the bytes
    the function must move."""
    Bsz, S, H, hd = x.shape
    N = Bmat.shape[3]
    flops = 0
    for s0 in range(0, S, CHUNK):
        q = min(CHUNK, S - s0)
        flops += q * (q + 1) * (N + hd) + q * (q + 1) * (hd + 2 * N) + 10 * q * hd * N
    return (flops * Bsz * H,
            work.nbytes(x, dt, A, Bmat, Cmat, initial_state, y_grad, *grads))


class SSDScan(torch.autograd.Function):
    """The SSD scan with its gradient: ``(y, final_state)`` of ``(x, dt, A,
    Bmat, Cmat, initial_state)``.  ``kernel`` chooses the CUDA kernels or the
    plain versions, for both directions.  The forward saves its inputs (x, B
    and C as they came: in the model, views of one conv output, whose
    gradients autograd routes back through the views); the backward
    recomputes the chunk states from them.  A cotangent that is None (the
    final state unused, as in training) counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, initial_state, kernel: bool):
        fwd = ssd_scan if kernel else ssd_scan_plain
        with work.muted():
            y, final = fwd(x, dt, A, Bmat, Cmat, initial_state=initial_state,
                           return_state=True)
        work.report(ssd_fwd_work, x, dt, A, Bmat, Cmat, initial_state, y, final)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, initial_state)
        ctx.kernel = kernel
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dfinal):
        x, dt, A, Bmat, Cmat, h0 = ctx.saved_tensors
        with work.muted():
            if dy is None:
                dy = torch.zeros_like(x)
            if ctx.kernel:
                # incoming gradients may be expanded or strided: the kernel
                # wants dy's rows and the final state's cotangent contiguous
                if dy.stride(3) != 1:
                    dy = dy.contiguous()
                if dfinal is not None:
                    dfinal = dfinal.contiguous()
            bwd = ssd_scan_bwd if ctx.kernel else ssd_scan_bwd_plain
            grads = bwd(x, dt, A, Bmat, Cmat, dy, initial_state=h0, final_state_grad=dfinal)
        work.report(ssd_bwd_work, x, dt, A, Bmat, Cmat, h0, dy, grads)
        dx, ddt, dA, dB, dC, dh0 = grads
        return dx, ddt, dA, dB, dC, dh0, None
