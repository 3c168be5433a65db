"""The bf16 SSD kernel's precision plan, emulated on the CPU.

``csrc/ssd_scan.cu``'s bf16 path runs its four products on the tensor cores
with bf16 operands and fp32 sums.  x, B and C are exact bf16 inputs; M (with
its exp and dt factors), w.x and the carried fp32 state are not, so the kernel
splits each into ``hi = bf16(v)`` and ``lo = bf16(v - hi)`` and multiplies
both.  ``ssd_tc_emulated`` repeats those roundings in torch: the splits, each
product as a sum over the kernel's 16-wide K slices in the kernel's order (hi,
then lo), fp32 accumulation, the decays as 2^x of cumulative sums in units of
log2.  It is held against ``ssd_scan_plain`` at ``chip_smoke.py``'s tolerances
(``MAIN_TOL`` and the row measure for y, ``SSD_STATE_TOL`` for the final
state) on mamba2's served decays (``make_ssd(..., served=True)``) at a reduced
shape.  With one bf16 rounding of the state update's operand instead of two
halves the final state leaves ``SSD_STATE_TOL``: that is why the kernel splits.

    PYTHONPATH=src python tests/test_torch_ssd_precision.py   # prints the errors
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import CHUNK, ssd_scan_plain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOG2E = 1.4426950408889634
BF16 = torch.bfloat16
F32 = torch.float32


def split(v, half=BF16):
    """``v`` as the kernel's two bf16 halves, hi = bf16(v) and lo =
    bf16(v - hi), returned in v's dtype."""
    hi = v.to(half).to(v.dtype)
    return hi, (v - hi).to(half).to(v.dtype)


def sliced(a, b, k_dim_a, k_dim_b, eq):
    """``einsum(eq, a, b)`` summed over the contracted dimension 16 at a
    time, in order, each slice's product and the running sum in fp32."""
    out = None
    for k0 in range(0, a.shape[k_dim_a], 16):
        part = torch.einsum(eq, a.narrow(k_dim_a, k0, 16), b.narrow(k_dim_b, k0, 16))
        out = part if out is None else out + part
    return out


def ssd_tc_emulated(x, dt, A, Bm, Cm, initial_state=None, *, split_update=True,
                    half=BF16, acc=F32):
    """The bf16 kernel's arithmetic.  x, B, C hold bf16 values (in bf16 or
    fp32); returns y in x's dtype and the final state in ``acc``.  With
    ``split_update=False`` the state update's operand w.x is rounded to bf16
    once, without its lo half.  ``half`` and ``acc`` replace bf16 and fp32
    (float64 for both: the kernel's order of operations without roundings)."""
    Bsz, S, H, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    n16 = max(N, 16)
    state = (torch.zeros(Bsz, H, hd, N, dtype=acc) if initial_state is None
             else initial_state.to(acc).clone())
    a2 = A.to(acc) * LOG2E
    y = torch.empty(Bsz, S, H, hd, dtype=x.dtype)
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    for s0 in range(0, S, CHUNK):
        q = min(CHUNK, S - s0)
        pad = CHUNK - q

        def chunk(t, heads):
            t = t[:, s0:s0 + q].to(acc)
            if heads is not None and heads > 1:
                t = t.repeat_interleave(heads, dim=2)
            return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xs = chunk(x, None).permute(0, 2, 1, 3)                       # (B,H,Q,hd)
        Bc = chunk(Bm, rep).permute(0, 2, 1, 3)                       # (B,H,Q,N)
        Cc = chunk(Cm, rep).permute(0, 2, 1, 3)
        if n16 > N:                                                   # N 8: depth 16
            Bc = torch.nn.functional.pad(Bc, (0, n16 - N))
            Cc = torch.nn.functional.pad(Cc, (0, n16 - N))
        dts = torch.nn.functional.pad(dt[:, s0:s0 + q].to(acc), (0, 0, 0, pad)).transpose(1, 2)
        cs = torch.cumsum(dts * a2[None, :, None], dim=-1)            # (B,H,Q), log2 units
        w = dts * torch.exp2(cs[..., -1:] - cs)
        cb = sliced(Cc, Bc, 3, 3, "bhin,bhjn->bhij")
        diff = torch.where(tri, cs[..., :, None] - cs[..., None, :], torch.zeros(()))
        M = torch.where(tri, cb * torch.exp2(diff) * dts[..., None, :], torch.zeros(()))
        mh, ml = split(M, half)
        y_in = None
        for j0 in range(0, CHUNK, 16):
            xj = xs[:, :, j0:j0 + 16]
            part = torch.einsum("bhij,bhjd->bhid", mh[..., j0:j0 + 16], xj)
            y_in = part if y_in is None else y_in + part
            y_in = y_in + torch.einsum("bhij,bhjd->bhid", ml[..., j0:j0 + 16], xj)
        sh, sl = split(torch.nn.functional.pad(state, (0, n16 - N)), half)
        y_x = None
        for k0 in range(0, n16, 16):
            ck = Cc[..., k0:k0 + 16]
            part = torch.einsum("bhin,bhdn->bhid", ck, sh[..., k0:k0 + 16])
            y_x = part if y_x is None else y_x + part
            y_x = y_x + torch.einsum("bhin,bhdn->bhid", ck, sl[..., k0:k0 + 16])
        yc = y_in + y_x * torch.exp2(cs)[..., None]
        y[:, s0:s0 + q] = yc[:, :, :q].permute(0, 2, 1, 3).to(x.dtype)
        wh, wl = split(xs * w[..., None], half)                       # (B,H,Q,hd)
        state = state * torch.exp2(cs[..., -1])[..., None, None]
        for k0 in range(0, CHUNK, 16):
            bk = Bc[:, :, k0:k0 + 16, :N]
            state = state + torch.einsum("bhqd,bhqn->bhdn", wh[:, :, k0:k0 + 16], bk)
            if split_update:
                state = state + torch.einsum("bhqd,bhqn->bhdn", wl[:, :, k0:k0 + 16], bk)
    return y, state


# the reduced shapes: (B, S, H, hd, N, G); S 455 leaves a ragged last chunk
SHAPES = [(1, 512, 4, 64, 128, 1), (1, 512, 4, 64, 64, 1),
          (1, 455, 4, 64, 128, 1), (1, 455, 4, 64, 64, 1)]


def inputs(shape, dtype, initial_state=False):
    """mamba2's served decays, x / B / C rounded to bf16 (the kernel's inputs),
    held in ``dtype``."""
    B, S, H, hd, N, G = shape
    x, dt, A, Bm, Cm, h0 = chip_smoke.make_ssd(
        23, B, S, H, hd, N, G, BF16, "cpu", served=True, fused=True,
        initial_state=initial_state)
    return (x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), h0)


def errors(args, **kw):
    """(y max abs err, y row err / row rms, state max abs err, state row
    measure, whether each is inside chip_smoke.py's limits)."""
    x, dt, A, Bm, Cm, h0 = args
    y, st = ssd_tc_emulated(x, dt, A, Bm, Cm, h0, **kw)
    y_ref, st_ref = ssd_scan_plain(x, dt, A, Bm, Cm, initial_state=h0, return_state=True)

    def inside(got, want, tol):
        err = (got.float() - want.float()).abs()
        return bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    return {"y_err": float((y.float() - y_ref.float()).abs().max()),
            "y_row": chip_smoke.row_rel_err(y, y_ref),
            "state_err": float((st - st_ref).abs().max()),
            "state_row": chip_smoke.row_rel_err(st, st_ref),
            "y_ok": inside(y, y_ref, chip_smoke.MAIN_TOL)
            and chip_smoke.row_rel_err(y, y_ref) <= chip_smoke.MAIN_ROW_REL_TOL,
            "state_ok": inside(st, st_ref, chip_smoke.SSD_STATE_TOL)
            and chip_smoke.row_rel_err(st, st_ref) <= chip_smoke.MAIN_ROW_REL_TOL}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("initial_state", [False, True])
def test_split_plan_holds_the_smoke_tolerances(shape, dtype, initial_state):
    e = errors(inputs(shape, getattr(torch, dtype), initial_state))
    assert e["y_ok"], e
    assert e["state_ok"], e
    assert math.isfinite(e["y_err"]) and math.isfinite(e["state_err"])


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_one_bf16_rounding_of_the_state_update_operand_is_not_enough(shape):
    """Why the kernel splits w.x: without its lo half the final state leaves
    SSD_STATE_TOL, while the split emulation on the same inputs stays inside."""
    args = inputs(shape, BF16)
    assert errors(args)["state_ok"]
    assert not errors(args, split_update=False)["state_ok"]


def test_emulation_is_the_plain_scan_without_the_roundings():
    """Without the bf16 roundings (float64 throughout) the emulated order of
    operations gives the plain scan's result: only the roundings differ."""
    x, dt, A, Bm, Cm, _ = inputs(SHAPES[2], F32)
    f64 = torch.float64
    y, st = ssd_tc_emulated(x.to(f64), dt, A, Bm.to(f64), Cm.to(f64), half=f64, acc=f64)
    y_ref, st_ref = ssd_scan_plain(*(t.to(f64) for t in (x, dt, A, Bm, Cm)), return_state=True)
    # the plain scan computes in fp32 whatever its inputs: held at the
    # reference's fp32 kernel tolerance
    torch.testing.assert_close(y, y_ref, atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(st, st_ref.to(f64), atol=2e-5, rtol=2e-4)


if __name__ == "__main__":
    for shape in SHAPES:
        for dtype in (BF16, F32):
            args = inputs(shape, dtype)
            print(shape, dtype, "split:", errors(args),
                  "single rounding of w.x:", errors(args, split_update=False))
