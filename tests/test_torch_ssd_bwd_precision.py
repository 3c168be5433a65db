"""The bf16 SSD backward's precision plan, emulated on the CPU.

``csrc/ssd_scan_bwd.cu``'s bf16 path runs its products on the tensor cores
with bf16 operands and fp32 sums.  x, dy, B and C are exact bf16 inputs; every
other operand is not, so the kernel splits it into ``hi = bf16(v)`` and ``lo =
bf16(v - hi)`` and multiplies both: coef.u in the two chains (w.x forward,
exp(cs).dy in reverse), the chunk states and their gradients (written by the
chains as hi and lo planes), and the chunk's M^T, Gd^T and Gd with their
decay and dt factors.  ``ssd_bwd_tc_emulated`` repeats those roundings in
torch: the splits, each product as a sum over 16-wide K slices in the
kernel's order (hi, then lo), fp32 sums, decays as exp of cumulative sums (as
the plain version; see ``test_decays_in_units_of_log2_flip_a_rounding``), dB
and dC summed over the heads of a block of k heads in head order and then over
the blocks.  It is held against ``ssd_scan_bwd_plain`` at
``chip_smoke.py``'s ``SSD_BWD_*`` limits (``hold_ssd_grads``) on mamba2's
served decays at a reduced shape.  One bf16 rounding of M, or of the chunk
kernel's dh operand, instead of two halves leaves those limits: that is why
the kernel splits them.

    PYTHONPATH=src python tests/test_torch_ssd_bwd_precision.py   # prints the errors
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import CHUNK, bwd_heads_per_block, ssd_scan_bwd_plain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF16 = torch.bfloat16
F32 = torch.float32


def split(v, half=BF16):
    """``v`` as the kernel's two bf16 halves, hi = bf16(v) and lo =
    bf16(v - hi), returned in v's dtype."""
    hi = v.to(half).to(v.dtype)
    return hi, (v - hi).to(half).to(v.dtype)


def sliced(eq, a_hi, a_lo, b_hi, b_lo, dim_a, dim_b, start=None):
    """``start + einsum(eq, a, b)``, the contracted dimension taken 16 at a
    time in order, each slice's product added to the running fp32 sum; an
    operand split into hi and lo gives two products a slice, hi first
    (``a_lo`` or ``b_lo`` is None for an exact operand)."""
    pairs = [(a_hi, b_hi)] + [(a_lo, b_hi)] * (a_lo is not None) + \
        [(a_hi, b_lo)] * (b_lo is not None)
    out = start
    for k0 in range(0, a_hi.shape[dim_a], 16):
        for a, b in pairs:
            part = torch.einsum(eq, a.narrow(dim_a, k0, 16), b.narrow(dim_b, k0, 16))
            out = part if out is None else out + part
    return out


def ssd_bwd_tc_emulated(x, dt, A, Bm, Cm, dy, initial_state=None, final_state_grad=None, *,
                        split_m=True, split_dh=True, log2=False, half=BF16, acc=F32):
    """The bf16 backward kernel's arithmetic: returns ``(dx, ddt, dA, dB, dC,
    dh0)`` as ``ssd_scan_bwd`` does.  ``split_m=False`` rounds M^T to bf16
    once, without its lo half; ``split_dh=False`` gives the chunk kernel's
    products dh's hi plane only; ``log2=True`` takes the decays as 2^x of
    cumulative sums in units of log2, as the forward kernel does.  ``half``
    and ``acc`` replace bf16 and fp32 (float64 for both: the kernel's order of
    operations without roundings)."""
    Bsz, S, H, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    k = bwd_heads_per_block(H, G)
    n16 = max(N, 16)
    nc = -(-S // CHUNK)
    a2 = A.to(acc) * (1.4426950408889634 if log2 else 1.0)
    ex = torch.exp2 if log2 else torch.exp
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))       # [i][j]: j <= i
    zero = torch.zeros((), dtype=acc)

    def chunk(t, c, heads=False):
        """Chunk c of a (B, S, ...) tensor in ``acc``, zero-padded to CHUNK rows,
        groups repeated over their heads, as (B, H, Q, ...)."""
        s0 = c * CHUNK
        t = t[:, s0:s0 + CHUNK].to(acc)
        if heads:
            t = t.repeat_interleave(rep, dim=2)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, CHUNK - t.shape[1]))
        return t.movedim(1, 2) if t.dim() == 4 else t.transpose(1, 2)

    xs = [chunk(x, c) for c in range(nc)]                                # (B,H,Q,hd)
    ys = [chunk(dy, c) for c in range(nc)]
    Bs = [chunk(Bm, c, True) for c in range(nc)]                         # (B,H,Q,N)
    Cs = [chunk(Cm, c, True) for c in range(nc)]
    dts = [chunk(dt, c) for c in range(nc)]                              # (B,H,Q)
    css = [torch.cumsum(d * a2[None, :, None], dim=-1) for d in dts]

    # ---- the chains: the carry in fp32, coef.u split, B or C exact, each
    # chunk's carry stored as hi and lo planes
    def chain(init, order, coef_of, u, v):
        carry = (torch.zeros(Bsz, H, hd, N, dtype=acc) if init is None
                 else init.to(acc).clone())
        planes = [None] * nc
        for c in order:
            planes[c] = split(carry, half)
            cs = css[c]
            uh, ul = split(u[c] * coef_of(c, cs)[..., None], half)
            carry = sliced("bhqd,bhqn->bhdn", uh, ul, v[c], None, 2, 2,
                            start=carry * ex(cs[..., -1])[..., None, None])
        return planes, carry

    states, _ = chain(initial_state, range(nc),
                      lambda c, cs: dts[c] * ex(cs[..., -1:] - cs), xs, Bs)
    dstates, dh0 = chain(final_state_grad, reversed(range(nc)),
                         lambda c, cs: ex(cs), ys, Cs)

    # ---- the chunks
    dx = torch.empty(Bsz, S, H, hd, dtype=x.dtype)
    ddt = torch.empty(Bsz, S, H, dtype=acc)
    dA_part = torch.zeros(Bsz, nc, H, dtype=acc)
    dB_part = torch.zeros(Bsz, S, G, rep // k, N, dtype=acc)
    dC_part = torch.zeros(Bsz, S, G, rep // k, N, dtype=acc)
    for c in range(nc):
        s0, q = c * CHUNK, min(CHUNK, S - c * CHUNK)
        xc, yc, Bc, Cc, dtc, cs = xs[c], ys[c], Bs[c], Cs[c], dts[c], css[c]
        hh_, hl = states[c]
        gh, gl = dstates[c] if split_dh else (dstates[c][0], None)
        pad = (0, n16 - N)
        Bp, Cp = (torch.nn.functional.pad(t, pad) for t in (Bc, Cc))
        ghp, glp = (None if t is None else torch.nn.functional.pad(t, pad) for t in (gh, gl))
        last = cs[..., -1:]
        w = dtc * ex(last - cs)                                  # (B,H,Q)
        dec = ex(last - cs)
        ecs = ex(cs)
        # L[j][i] = exp(cs_i - cs_j) for i >= j (the transposed layout, rows j)
        lt = tri.T
        Lt = torch.where(lt, ex(torch.where(lt, cs[..., None, :] - cs[..., :, None],
                                                    zero)), zero)
        BC = sliced("bhjn,bhin->bhji", Bp, None, Cp, None, 3, 3)                     # B_j . C_i
        XD = sliced("bhjd,bhid->bhji", xc, None, yc, None, 3, 3)                     # x_j . dy_i
        dtj = dtc[..., :, None]
        gdT = XD * Lt * dtj
        mT = BC * Lt * dtj
        gm = BC * XD * Lt
        pp = gm * dtj
        colP, colG, rowP = pp.sum(-1), gm.sum(-1), pp.sum(-2)
        # dx
        mh, ml = split(mT, half) if split_m else (mT.to(half).to(acc), None)
        dxa = sliced("bhji,bhid->bhjd", mh, ml, yc, None, 3, 2)
        dxb = sliced("bhjn,bhdn->bhjd", Bp, None, ghp, glp, 3, 3)
        Ux = (xc * dxb).sum(-1)
        dx[:, s0:s0 + q] = (dxa + w[..., None] * dxb)[:, :, :q].movedim(2, 1).to(x.dtype)
        # dB and dC of each head: the products into the running sum, then the
        # state term times w_j (dB) or exp(cs_i) (dC)
        gdh, gdl = split(gdT, half)
        dB_in = [sliced("bji,bin->bjn", gdh[:, h], gdl[:, h], Cc[:, h], None, 2, 1)
                 for h in range(H)]
        tb = sliced("bhjd,bhdn->bhjn", xc, None, gh, gl, 3, 2)
        DX = sliced("bhid,bhjd->bhij", yc, None, xc, None, 3, 3)                     # dy_i . x_j
        L = Lt.transpose(-1, -2)                                          # [i][j]
        gi = DX * L * dtc[..., None, :]
        gih, gil = split(gi, half)
        dC_in = [sliced("bij,bjn->bin", gih[:, h], gil[:, h], Bc[:, h], None, 2, 1)
                 for h in range(H)]
        tc = ecs[..., None] * sliced("bhid,bhdn->bhin", yc, None, hh_, hl, 3, 2)
        inn = (Cc * tc).sum(-1)
        for grp in range(G):
            for kb in range(rep // k):
                sB = sC = torch.zeros(Bsz, CHUNK, N, dtype=acc)
                for h in range(grp * rep + kb * k, grp * rep + (kb + 1) * k):
                    sB = sB + dB_in[h]
                    sB = sB + w[:, h, :, None] * tb[:, h]
                    sC = sC + dC_in[h]
                    sC = sC + tc[:, h]
                dB_part[:, s0:s0 + q, grp, kb] = sB[:, :q]
                dC_part[:, s0:s0 + q, grp, kb] = sC[:, :q]
        # dcs, its reverse cumulative sum, ddt and dA
        hdot = (sum(dstates[c]) * (hh_ + hl)).sum((-2, -1))
        dcs = rowP - colP + inn - w * Ux
        dcs[..., -1] += ex(last[..., 0]) * hdot + (w * Ux).sum(-1)
        da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
        ddt[:, s0:s0 + q] = (colG + dec * Ux + A.to(acc)[None, :, None] * da)[..., :q] \
            .transpose(1, 2)
        dA_part[:, c] = (dtc * da).sum(-1)
    dA = dA_part.sum((0, 1))
    dB = dB_part.sum(3).to(Bm.dtype)
    dC = dC_part.sum(3).to(Cm.dtype)
    return (dx, ddt.to(F32), dA.to(F32), dB, dC,
            dh0.to(F32) if initial_state is not None else None)


# the reduced shapes: (B, S, H, hd, N, G); S 200 leaves a ragged last chunk;
# 16 heads in 2 groups give two blocks of 8 heads per group
SHAPES = [(1, 256, 8, 64, 128, 1), (1, 200, 16, 64, 64, 2)]


def inputs(shape, dtype, initial_state=False, final=False):
    """mamba2's served decays, x / B / C / dy rounded to bf16 (the kernel's
    inputs), held in ``dtype``."""
    B, S, H, hd, N, G = shape
    x, dt, A, Bm, Cm, h0 = chip_smoke.make_ssd(
        23, B, S, H, hd, N, G, BF16, "cpu", served=True, fused=True,
        initial_state=initial_state)
    dy, dhT = chip_smoke.ssd_cotangents(24, B, S, H, hd, N, BF16, "cpu", final)
    return (x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), dy.to(dtype), h0, dhT)


def held(args, **kw):
    """``hold_ssd_grads`` of the emulation against ``ssd_scan_bwd_plain``:
    {gradient: [max abs err over the largest magnitude, Frobenius]}; raises
    AssertionError outside the limits."""
    x, dt, A, Bm, Cm, dy, h0, dhT = args
    got = ssd_bwd_tc_emulated(x, dt, A, Bm, Cm, dy, h0, dhT, **kw)
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, initial_state=h0, final_state_grad=dhT)
    return chip_smoke.hold_ssd_grads("emulated bf16 backward", got, want, BF16)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("state", [False, True])
def test_split_plan_holds_the_smoke_limits(shape, state):
    readings = held(inputs(shape, BF16, initial_state=state, final=state))
    assert set(readings) >= {"dx", "ddt", "dA", "dB", "dC"}


@pytest.mark.parametrize("what", ["split_m", "split_dh"])
def test_one_bf16_rounding_inside_leaves_the_limits(what):
    """Why the kernel splits M and the chunk states' gradient: with one bf16
    rounding instead of two halves the emulation leaves the smoke's bf16
    limits, where the split plan on the same inputs stays inside."""
    args = inputs(SHAPES[0], BF16)
    held(args)
    with pytest.raises(AssertionError, match="dx"):
        held(args, **{what: False})


def test_decays_in_units_of_log2_flip_a_rounding():
    """Why the backward takes its decays as exp of natural-unit sums, as the
    plain version does: at the sweep's (2, 100, 4, 16, 8, 1) one dC element
    lies 1e-6 of itself from a bf16 midpoint, and 2^x of sums in units of
    log2 (the forward kernel's choice) moves it across, 4.5e-4 of dC's norm
    against the 3e-4 limit, even with no bf16 split at all."""
    B, S, H, hd, N, G = 2, 100, 4, 16, 8, 1
    x, dt, A, Bm, Cm, _ = chip_smoke.make_ssd(13, B, S, H, hd, N, G, BF16, "cpu")
    dy, _ = chip_smoke.ssd_cotangents(14, B, S, H, hd, N, BF16, "cpu")
    args = (x, dt, A, Bm, Cm, dy, None, None)
    held(args)
    held(args, half=F32)
    with pytest.raises(AssertionError, match="dC"):
        held(args, log2=True, half=F32)


def test_emulation_is_the_plain_backward_without_the_roundings():
    """Without the bf16 roundings (float64 throughout) the emulated order of
    operations gives the plain backward's gradients: only the roundings
    differ."""
    x, dt, A, Bm, Cm, dy, h0, dhT = inputs(SHAPES[1], F32, initial_state=True, final=True)
    f64 = torch.float64
    got = ssd_bwd_tc_emulated(*(t.to(f64) for t in (x, dt, A, Bm, Cm, dy)), h0, dhT,
                              half=f64, acc=f64)
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, initial_state=h0, final_state_grad=dhT)
    # the plain backward computes in fp32 whatever its inputs: held at the
    # smoke's fp32 limits (ddt and dA by Frobenius, as there)
    chip_smoke.hold_ssd_grads("emulated float64 backward",
                              [None if g is None else g.to(F32) for g in got], want, F32)


if __name__ == "__main__":
    for shape in SHAPES:
        args = inputs(shape, BF16, initial_state=True, final=True)
        print(shape, "split plan:", held(args))
        for what in ("split_m", "split_dh"):
            try:
                print(shape, f"{what}=False:", held(args, **{what: False}))
            except AssertionError as e:
                print(shape, f"{what}=False: outside the limits:", e)
