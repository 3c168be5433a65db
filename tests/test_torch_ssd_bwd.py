"""The SSD scan's backward on the CPU: ``ssd_scan_bwd_plain`` (the arithmetic
of the hand-written backward kernel, an explicit reverse walk over the chunks
in tensor ops) against autograd through the port's ``ssd_scan_plain`` and
against ``jax.grad`` of the JAX package's ``ssd_chunked``
(``src/repro/models/ssm.py:100``, how the JAX model trains) and of its
sequential ``ssd_reference``; its independence of the chunk; gradients that
reach the conv output through the strided views the model passes; and the
kernel wrapper's refusal of CPU tensors.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against ``ssd_scan_bwd_plain`` there.

Tolerance ``REL`` = 1e-5, relative: every element of a gradient within
1e-5 of the gradient's largest magnitude, and its Frobenius error within
1e-5 of its norm.  Both sides compute in fp32 with sums in another order.
dA alone is held to ``REL_DA`` = 1e-4: it is a sum over every token of a
batch of terms that cancel, and on these inputs every fp32 evaluation of it
(this one, autograd through ``ssd_scan_plain``, ``jax.grad``) differs from
a float64 evaluation by up to 3.3e-5 of its size, while the other gradients
agree with it to 3.3e-6.  Run this file as a script to print those errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (SSDScan, ssd_scan_bwd, ssd_scan_bwd_plain,
                                          ssd_scan_plain)

REL = 1e-5
REL_DA = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")

# (B, S, H, hd, N, G, initial state, final-state cotangent): G 1 and 2, ragged
# last chunks (100 = 64 + 36, 130 = 2 x 64 + 2), one chunk and less than one
CASES = [(2, 100, 4, 16, 8, 2, True, True), (1, 64, 4, 16, 8, 1, False, False),
         (2, 130, 4, 8, 16, 1, True, False), (1, 40, 2, 16, 8, 2, False, True)]


def case_id(c):
    return "x".join(map(str, c[:6])) + f"-h0{int(c[6])}-dhT{int(c[7])}"


def make(B, S, H, hd, N, G, h0, dhT, seed=0):
    """numpy inputs: x 0.5 N(0,1), B and C 0.4 N(0,1), dt = softplus(N(0,1)),
    A = -exp(0.3 N(0,1)), h0 0.5 N(0,1), and the cotangents dy, dhT N(0,1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, hd)).astype(f) * f(0.5)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(f)
    Bm = rng.standard_normal((B, S, G, N)).astype(f) * f(0.4)
    Cm = rng.standard_normal((B, S, G, N)).astype(f) * f(0.4)
    init = rng.standard_normal((B, H, hd, N)).astype(f) * f(0.5) if h0 else None
    dy = rng.standard_normal((B, S, H, hd)).astype(f)
    dh = rng.standard_normal((B, H, hd, N)).astype(f) if dhT else None
    return x, dt, A, Bm, Cm, init, dy, dh


def torch_or_none(a):
    return None if a is None else torch.from_numpy(a)


def plain_grads(args, **kw):
    x, dt, A, Bm, Cm, h0, dy, dh = (torch_or_none(a) for a in args)
    return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, initial_state=h0, final_state_grad=dh,
                              **kw)


def autograd_grads(args):
    x, dt, A, Bm, Cm, h0, dy, dh = (torch_or_none(a) for a in args)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    if h0 is not None:
        leaves.append(h0.clone().requires_grad_())
    y, hT = ssd_scan_plain(*leaves[:5], initial_state=leaves[5] if h0 is not None else None,
                           return_state=True)
    loss = (y * dy).sum() + ((hT * dh).sum() if dh is not None else 0.0)
    return torch.autograd.grad(loss, leaves)


def jax_grads(args, fn):
    x, dt, A, Bm, Cm, h0, dy, dh = args
    n_in = 5 if h0 is None else 6

    def loss(*ins):
        y, hT = fn(*ins[:5], initial_state=ins[5] if n_in == 6 else None)
        out = jnp.sum(y * dy)
        return out + jnp.sum(hT * dh) if dh is not None else out
    ins = tuple(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)[:n_in])
    return jax.jit(jax.grad(loss, argnums=tuple(range(n_in))))(*ins)


def rel_close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)
    fro = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert fro <= rel, f"{what}: Frobenius relative error {fro:.3e}"


def check(got, want, has_h0):
    assert (got[5] is not None) == has_h0
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        rel_close(g.numpy(), w, name, REL_DA if name == "dA" else REL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bwd_plain_matches_autograd_through_the_plain_scan(case):
    args = make(*case)
    check(plain_grads(args), [w.numpy() for w in autograd_grads(args)], case[6])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bwd_plain_matches_jax_grad_of_ssd_chunked(case):
    args = make(*case, seed=1)

    def chunked(*ins, initial_state):
        return jssm.ssd_chunked(*ins, initial_state=initial_state, return_state=True)
    check(plain_grads(args), jax_grads(args, chunked), case[6])


@pytest.mark.parametrize("case", CASES[:2], ids=case_id)
def test_bwd_plain_matches_jax_grad_of_the_sequential_reference(case):
    args = make(*case, seed=2)

    def reference(*ins, initial_state):
        return jssm.ssd_reference(*ins, initial_state=initial_state, return_state=True)
    check(plain_grads(args), jax_grads(args, reference), case[6])


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_bwd_plain_independent_of_the_chunk(chunk):
    args = make(2, 150, 4, 16, 8, 2, True, True, seed=3)
    want = plain_grads(args, chunk=64)
    check(plain_grads(args, chunk=chunk), [w.numpy() for w in want], True)


def test_bwd_plain_keeps_the_dtypes():
    """bf16 x, B, C: dx, dB, dC come back in bf16, ddt, dA, dh0 in fp32, and
    agree with the fp32 backward of the same bf16 values to bf16's rounding
    of the outputs (2^-8 of the largest magnitude, and 1e-2 by Frobenius)."""
    x, dt, A, Bm, Cm, h0, dy, dh = (torch_or_none(a)
                                    for a in make(1, 100, 4, 16, 8, 2, True, True, seed=4))
    lo = [t.to(torch.bfloat16) for t in (x, Bm, Cm, dy)]
    got = ssd_scan_bwd_plain(lo[0], dt, A, lo[1], lo[2], lo[3], initial_state=h0,
                             final_state_grad=dh)
    want = ssd_scan_bwd_plain(lo[0].float(), dt, A, lo[1].float(), lo[2].float(),
                              lo[3].float(), initial_state=h0, final_state_grad=dh)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "dB", "dC") else torch.float32)
        g, w = g.float(), w.float()
        assert float((g - w).abs().max()) <= 2 ** -8 * float(w.abs().max()), name
        assert float((g - w).norm() / w.norm()) <= 1e-2, name


def test_gradients_reach_the_conv_output_through_the_strided_views():
    """As ``mamba2_forward`` passes them: x, B and C are views of one conv
    output (B, S, H*hd + 2GN).  ``ops.ssd`` under grad goes through
    ``SSDScan``, and the conv output's gradient is dx, dB, dC laid side by
    side, equal to those of ``ssd_scan_bwd_plain`` (REL)."""
    B, S, H, hd, N, G = 2, 90, 4, 16, 8, 2
    x, dt, A, Bm, Cm, _, dy, _ = (torch_or_none(a) for a in make(B, S, H, hd, N, G, False, False,
                                                                 seed=5))
    di = H * hd
    xbc = torch.cat([x.flatten(2), Bm.flatten(2), Cm.flatten(2)], -1).requires_grad_()
    xv = xbc[..., :di].view(B, S, H, hd)
    Bv = xbc[..., di:di + G * N].view(B, S, G, N)
    Cv = xbc[..., di + G * N:].view(B, S, G, N)
    assert not xv.is_contiguous() and xv.stride(3) == 1
    y, hT = ops.ssd(xv, dt, A, Bv, Cv, return_state=True)
    assert "SSDScan" in type(y.grad_fn).__name__
    y.backward(dy)                                   # hT unused: its cotangent is zero
    dx, _, _, dB, dC, dh0 = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy)
    assert dh0 is None
    want = torch.cat([dx.flatten(2), dB.flatten(2), dC.flatten(2)], -1)
    rel_close(xbc.grad.numpy(), want.numpy(), "d xBC")


def test_the_function_takes_the_initial_state_and_the_final_cotangent():
    """``SSDScan`` on the plain route: (y, final state) and the gradients of
    a loss of both, the initial state's included, equal autograd's (REL)."""
    args = make(1, 70, 2, 16, 8, 1, True, True, seed=6)
    x, dt, A, Bm, Cm, h0, dy, dh = (torch_or_none(a) for a in args)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
    y, hT = SSDScan.apply(*leaves, False)
    got = torch.autograd.grad((y * dy).sum() + (hT * dh).sum(), leaves)
    check(got, [w.numpy() for w in autograd_grads(args)], True)


def test_the_backward_kernel_wrapper_takes_cuda_tensors_only():
    x, dt, A, Bm, Cm, h0, dy, dh = (torch_or_none(a) for a in make(*CASES[0]))
    with pytest.raises(ValueError, match="CUDA kernel"):
        ssd_scan_bwd(x, dt, A, Bm, Cm, dy, initial_state=h0, final_state_grad=dh)


def sequential_grads_float64(args):
    """The gradients of the per-token recurrence in float64 (autograd), for
    the script below: ``ssd_scan_plain`` and ``ssd_reference`` compute in
    fp32 whatever their inputs."""
    x, dt, A, Bm, Cm, h0, dy, dh = (None if a is None else torch.from_numpy(a).double()
                                    for a in args)
    leaves = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    if h0 is not None:
        leaves.append(h0.requires_grad_())
    rep = x.shape[2] // Bm.shape[2]
    h = h0 if h0 is not None else torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[3],
                                              dtype=torch.float64)
    loss = 0.0
    for t in range(x.shape[1]):
        Bh, Ch = (m[:, t].repeat_interleave(rep, dim=1) for m in (Bm, Cm))
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + \
            torch.einsum("bh,bhd,bhn->bhdn", dt[:, t], x[:, t], Bh)
        loss = loss + (torch.einsum("bhn,bhdn->bhd", Ch, h) * dy[:, t]).sum()
    if dh is not None:
        loss = loss + (h * dh).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


if __name__ == "__main__":
    # each fp32 evaluation of the gradients against float64, as (largest
    # error over the largest magnitude) per gradient, on the tests' inputs
    def chunked(*ins, initial_state):
        return jssm.ssd_chunked(*ins, initial_state=initial_state, return_state=True)

    def worst(got, want):
        return {n: f"{np.abs(np.asarray(g, np.float64) - w).max() / np.abs(w).max():.1e}"
                for n, g, w in zip(NAMES, got, want)}
    for case in CASES:
        for seed in (0, 1):
            args = make(*case, seed=seed)
            ref = sequential_grads_float64(args)
            print(case_id(case), seed, "plain:", worst(plain_grads(args), ref))
            print("    autograd:", worst([g.numpy() for g in autograd_grads(args)], ref))
            print("    jax:", worst(jax_grads(args, chunked), ref))
