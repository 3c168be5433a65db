"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.

Counterpart of ``repro.models.ssm``.  Per head h with state size N:

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * x_t B_t^T        (hd x N state)
    y_t = h_t C_t  (+ D_h * x_t)

Prefill and training run the chunked SSD algorithm through
``kernels.ops.ssd``: on the card the hand-written kernel, on the CPU its plain
version (``kernels.ssd_scan.ssd_scan_plain``); under autograd the backward
kernel or its plain version (``SSDScan``).  The chunked arithmetic exists once in
the port: ``ssd_chunked`` below is that plain version under its JAX name
(with the JAX default chunk of 128); the results do not depend on the chunk.
Decode (``S == 1`` with a state) keeps the O(1) recurrence in plain PyTorch,
as the JAX package keeps it in jnp.  ``ssd_reference`` is the sequential
oracle.

What differs from the JAX file: ``mamba2_forward`` takes no ``chunk`` (the
kernel's is fixed at 64); x, B and C reach the scan as strided views of the
conv output, not as copies; initialisers draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ssd_scan import segsum as _segsum   # noqa: F401  (JAX name)
from ..kernels.ssd_scan import ssd_scan_plain
from .modules import dense_init, ones_init, rms_norm, zeros_init


class SSMState(NamedTuple):
    """Per-layer decode state (stacked on a leading layer axis in a
    ``DecodeState``)."""
    h: torch.Tensor       # (B, H, hd, N) SSM state, fp32
    conv: torch.Tensor    # (B, d_conv-1, conv_dim) conv lag buffer


def init_mamba2(gen: torch.Generator, cfg, dtype=torch.float32,
                device="cuda"):
    d, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * G * N
    # in_proj emits [z (gate), x, B, C, dt]
    d_in_proj = 2 * di + 2 * G * N + H
    kw = dict(dtype=dtype, device=device)
    u = torch.rand((H,), generator=gen, dtype=torch.float32, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": dense_init(gen, (d, d_in_proj), **kw),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim),
                             scale=1.0 / math.sqrt(cfg.ssm_conv), **kw),
        "conv_b": zeros_init((conv_dim,), **kw),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)).to(dtype),
        "dt_bias": torch.log(torch.expm1(dt0)).to(dtype),
        "d_skip": ones_init((H,), **kw),
        "norm_g": ones_init((di,), **kw),
        "out_proj": dense_init(gen, (di, d), **kw),
    }


def mamba2_axes(cfg):
    """The logical axes of ``init_mamba2``'s tensors."""
    return {"in_proj": ("embed", "ssm_in"), "conv_w": ("null", "ssm_in"),
            "conv_b": ("ssm_in",), "a_log": ("ssm_head",), "dt_bias": ("ssm_head",),
            "d_skip": ("ssm_head",), "norm_g": ("ssm_in",), "out_proj": ("ssm_in", "embed")}


def _split_in_proj(zxbcdt: torch.Tensor, cfg):
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 lag: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d with fp32 accumulation.  xBC: (B,S,C); conv_w:
    (K,C).  ``lag``: optional (B, K-1, C) left context (the decode buffer).
    Returns (out, new_lag)."""
    K = conv_w.shape[0]
    B, S, C = xBC.shape
    if lag is None:
        lag = xBC.new_zeros((B, K - 1, C))
    xfull = torch.cat([lag, xBC], dim=1)                      # (B, S+K-1, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + xfull[:, i:i + S].float() * conv_w[i].float()
    out = F.silu(out + conv_b.float()).to(xBC.dtype)
    return out, xfull[:, S:]


def ssd_chunked(x, dt, A, Bmat, Cmat, *, chunk: int = 128,
                initial_state=None, return_state: bool = False):
    """The chunked SSD scan in tensor ops (``ssd_scan_plain``), at the JAX
    function's default chunk."""
    return ssd_scan_plain(x, dt, A, Bmat, Cmat, initial_state=initial_state,
                          return_state=return_state, chunk=chunk)


def ssd_reference(x, dt, A, Bmat, Cmat, initial_state=None,
                  return_state: bool = False):
    """Sequential per-token recurrence, in fp32: the oracle for tests."""
    Bsz, S, H, hd = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    h = (torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    Af = A.float()
    ys = []
    for t in range(S):
        Bh = Bmat[:, t].float().repeat_interleave(rep, dim=1)     # (B,H,N)
        Ch = Cmat[:, t].float().repeat_interleave(rep, dim=1)
        dtt = dt[:, t].float()                                    # (B,H)
        upd = torch.einsum("bh,bhd,bhn->bhdn", dtt, x[:, t].float(), Bh)
        h = h * torch.exp(dtt * Af)[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhdn->bhd", Ch, h))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def _scan_heads(x, dt, A, Bmat, Cmat, h0, decode: bool):
    """The SSD scan of some heads: ``ops.ssd`` over the sequence, or at
    ``decode`` (S == 1 with a state ``h0``) the O(1) recurrence.  Returns
    (y (B, S, H, hd), final state (B, H, hd, N), fp32)."""
    if decode:
        H, G = x.shape[2], Bmat.shape[2]
        decay = torch.exp(dt[:, 0] * A)                       # (B,H)
        Bh = Bmat[:, 0].float().repeat_interleave(H // G, dim=1)
        Ch = Cmat[:, 0].float().repeat_interleave(H // G, dim=1)
        upd = torch.einsum("bh,bhd,bhn->bhdn", dt[:, 0], x[:, 0].float(), Bh)
        hT = h0.float() * decay[..., None, None] + upd
        y = torch.einsum("bhn,bhdn->bhd", Ch, hT)[:, None].to(x.dtype)
        return y, hT
    h0 = h0.float().contiguous() if h0 is not None else None
    return ops.ssd(x, dt, A, Bmat, Cmat, initial_state=h0, return_state=True)


def mamba2_forward(params, u: torch.Tensor, cfg, *,
                   state: Optional[SSMState] = None,
                   return_state: bool = False, tp=None):
    """Full Mamba2 mixer.  u: (B, S, d_model) → (B, S, d_model).  ``tp``: a
    ``parallel.tp.TPContext``, the mixer of a TP group (``_mamba2_tp``)."""
    if tp is not None:
        return _mamba2_tp(params, u, cfg, tp, state, return_state)
    B, S, _ = u.shape
    H, hd, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    di = cfg.d_inner

    zxbcdt = u @ params["in_proj"]
    z, xBC, dt = _split_in_proj(zxbcdt, cfg)
    lag = state.conv if state is not None else None
    xBC, new_lag = _causal_conv(xBC, params["conv_w"], params["conv_b"], lag)
    # strided views of the conv output: the scan reads them in place
    x = xBC[..., :di].view(B, S, H, hd)
    Bmat = xBC[..., di:di + G * N].view(B, S, G, N)
    Cmat = xBC[..., di + G * N:].view(B, S, G, N)
    A = -torch.exp(params["a_log"].float())
    dt = F.softplus(dt.float() + params["dt_bias"].float())   # (B,S,H)
    y, hT = _scan_heads(x, dt, A, Bmat, Cmat, state.h if state is not None else None,
                        S == 1 and state is not None)

    y = y + x * params["d_skip"].to(u.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2's norm-before-out)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm_g"],
                 cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, SSMState(h=hT, conv=new_lag)
    return out


def tp_groups(cfg, size: int):
    """For each coordinate of a TP axis of ``size`` ranks, the slice of the
    B / C groups its ``ssm_heads / size`` heads read; a ``ValueError`` (naming
    ROADMAP.md M9b2b) where the heads do not divide the ranks, or a rank's
    heads neither cover whole groups nor lie in one."""
    H, G = cfg.ssm_heads, cfg.ssm_groups
    if H % size:
        raise ValueError(
            f"{H} SSM heads of {cfg.name} do not divide over {size} ranks; padding them "
            "under tensor parallelism waits for ROADMAP.md M9b2b")
    Hr, per = H // size, H // G
    if Hr % per == 0:
        return [slice(c * Hr // per, (c + 1) * Hr // per) for c in range(size)]
    if per % Hr == 0:
        return [slice(c * Hr // per, c * Hr // per + 1) for c in range(size)]
    raise ValueError(
        f"{cfg.name}: a rank's {Hr} SSM heads straddle the groups of {per} heads "
        f"({G} groups) over {size} ranks; that split waits for ROADMAP.md M9b2b")


def _mamba2_tp(params, u, cfg, tp, state, return_state):
    """``mamba2_forward`` of a TP group.  The sharded leaves are in the rows
    form over the TP axis (``parallel.sharding``'s ``spec``): a rank holds a
    contiguous block of the fused ``[z | x | B | C | dt]`` columns of
    ``in_proj`` and of the ``x | B | C`` channels of ``conv_w`` / ``conv_b``
    (both straddle the components), its heads' ``a_log`` / ``dt_bias`` /
    ``d_skip`` and its heads' block of ``norm_g`` and of ``out_proj``'s rows.
    ``u`` goes through f; each rank projects its columns, and one gather
    makes the whole projection on every rank; each rank convolves its block
    of channels (with its block of the conv lag, ``ssm_state_spec``'s), and
    a second gather makes the whole conv output; each rank then scans its
    heads (its x, z and dt, the B / C groups they read, its block of the
    state ``h``) through ``ops.ssd``, adds the D skip and gates.  The gated
    RMSNorm's mean runs over all of ``d_inner``: each rank's (B, S) sum of
    squares goes through g and the mean back through f, so the two
    all-reduces move B x S values, not the (B, S, d_inner) a gather would.
    Each rank multiplies by its rows of ``out_proj``; g sums the partials.
    A state holds the rows form's heads and conv channels."""
    B, S, _ = u.shape
    hd, N, G, di = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups, cfg.d_inner
    groups = tp_groups(cfg, tp.size)
    Hr, dr, cr = cfg.ssm_heads // tp.size, di // tp.size, (di + 2 * G * N) // tp.size
    dt0 = 2 * di + 2 * G * N                   # the dt columns of the projection
    decode = S == 1 and state is not None
    ur = tp.copy(u)
    zxbcdt = tp.gather(torch.stack([ur[r] @ params["in_proj"][r] for r in range(tp.rows)]))
    convs, lags = [], []
    for r, c in enumerate(tp.coords):
        lag = state.conv[..., r * cr:(r + 1) * cr] if state is not None else None
        out, lag = _causal_conv(zxbcdt[r][..., di + c * cr:di + (c + 1) * cr],
                                params["conv_w"][r], params["conv_b"][r], lag)
        convs.append(out)
        lags.append(lag)
    xBC = tp.gather(torch.stack(convs))
    gated, squares, hs = [], [], []
    for r, c in enumerate(tp.coords):
        row, proj, g = xBC[r], zxbcdt[r], groups[c]
        x = row[..., c * dr:(c + 1) * dr].view(B, S, Hr, hd)
        Bmat = row[..., di:di + G * N].view(B, S, G, N)[:, :, g]
        Cmat = row[..., di + G * N:].view(B, S, G, N)[:, :, g]
        A = -torch.exp(params["a_log"][r].float())
        dt = F.softplus(proj[..., dt0 + c * Hr:dt0 + (c + 1) * Hr].float() +
                        params["dt_bias"][r].float())
        h0 = state.h[:, r * Hr:(r + 1) * Hr] if state is not None else None
        y, hT = _scan_heads(x, dt, A, Bmat, Cmat, h0, decode)
        y = y + x * params["d_skip"][r].to(u.dtype)[None, None, :, None]
        y = y.reshape(B, S, dr)
        y = y * F.silu(proj[..., c * dr:(c + 1) * dr].float()).to(y.dtype)
        gated.append(y)
        squares.append(y.float().square().sum(dim=-1))
        hs.append(hT)
    var = tp.copy(tp.reduce(torch.stack(squares)) / di)
    out = tp.reduce(torch.stack([
        ((y.float() * torch.rsqrt(var[r] + cfg.norm_eps)[..., None] *
          params["norm_g"][r].float()).to(y.dtype)) @ params["out_proj"][r]
        for r, y in enumerate(gated)]))
    if return_state:
        return out, SSMState(h=torch.cat(hs, dim=1), conv=torch.cat(lags, dim=-1))
    return out


def init_ssm_state(cfg, batch: int, dtype=torch.float32,
                   device="cuda", tp=None) -> SSMState:
    """A zeroed state; with ``tp`` the rows form's heads and conv channels
    (every one on a ``StackedMesh``, this rank's on a ``DistMesh``)."""
    H, hd, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * N
    if tp is not None:
        H, conv_dim = tp.heads(H), conv_dim // tp.size * tp.rows
    return SSMState(
        h=torch.zeros((batch, H, hd, N), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
    )
