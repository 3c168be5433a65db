"""The port's SSD scan and Mamba2 mixer on the CPU, held against the JAX
package on the same numpy inputs and (converted) weights.

``ssd_scan_plain`` is the plain PyTorch version that sits beside the CUDA
kernel (``csrc/ssd_scan.cu``) and repeats its arithmetic; the kernel itself
cannot run here, ``chip_smoke.py`` holds it against the plain version on the
card.  Tolerances, and why:

* against the Pallas kernel (interpret mode) and ``ssd_reference`` on the
  reference's sweep: the reference's own atol 5e-4 / rtol 5e-3
  (``tests/test_kernels.py::test_ssd_scan_sweep``);
* initial state in, final state out, against JAX ``ssd_chunked`` (fp32 both
  sides, chunked sums in another order): atol 2e-5 / rtol 2e-4, the
  reference's fp32 kernel tolerance;
* carried state (two halves equal one run) and the chunk size: the
  reference's atol 2e-4 / rtol 1e-3 (``tests/test_models.py``);
* bf16 inputs against JAX ``ssd_chunked``: atol = rtol = 2e-2 (the port keeps
  M in fp32 where JAX rounds it to bf16 before the second product);
* single functions (``_causal_conv``, ``_segsum``, ``mamba2_forward``):
  ``FN_TOL`` of ``tests/test_torch_models.py``, atol 1e-5 / rtol 1e-5 — the
  same arithmetic, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models import modules as jmod
from repro.models import ssm as jssm

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import CHUNK, ssd_scan, ssd_scan_plain
from repro_torch.models import ssm

SWEEP_TOL = dict(atol=5e-4, rtol=5e-3)
STATE_TOL = dict(atol=2e-5, rtol=2e-4)
CARRY_TOL = dict(atol=2e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FN_TOL = dict(atol=1e-5, rtol=1e-5)


def make_ssd(B, S, H, hd, N, G, seed=0, state=False):
    """The reference sweep's draws, made with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.4).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.4).astype(np.float32)
    h0 = (rng.standard_normal((B, H, hd, N)) * 0.5).astype(np.float32) \
        if state else None
    return (x, dt, A, Bm, Cm), h0


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a))                  # a writable copy
    return t if dtype is None else t.to(dtype)


def J(a, dtype=None):
    x = jnp.asarray(a)
    return x if dtype is None else x.astype(dtype)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(64, 16), (100, 32), (96, 96)])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_matches_pallas_interpret_and_reference_on_the_sweep(S, chunk, G):
    arrs, _ = make_ssd(2, S, 4, 16, 8, G)
    ref = jssm.ssd_reference(*map(J, arrs))
    pallas = j_ssd_scan(*map(J, arrs), chunk=chunk, interpret=True)
    for c in (chunk, CHUNK):
        out = ssd_scan_plain(*map(T, arrs), chunk=c)
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(as_np(out), as_np(ref), **SWEEP_TOL)
        np.testing.assert_allclose(as_np(out), as_np(pallas), **SWEEP_TOL)
    # and the port's own sequential oracle
    np.testing.assert_allclose(as_np(ssm.ssd_reference(*map(T, arrs))),
                               as_np(ref), **FN_TOL)


@pytest.mark.parametrize("B,S,H,hd,N,G", [(2, 64, 4, 16, 8, 1),
                                          (2, 100, 4, 16, 8, 2),
                                          (1, 130, 6, 16, 16, 3),
                                          (2, 7, 2, 8, 4, 1)])
def test_initial_state_in_and_final_state_out_match_jax(B, S, H, hd, N, G):
    arrs, h0 = make_ssd(B, S, H, hd, N, G, seed=1, state=True)
    jy, jh = jssm.ssd_chunked(*map(J, arrs), initial_state=J(h0),
                              return_state=True)
    y, h = ssd_scan_plain(*map(T, arrs), initial_state=T(h0), return_state=True)
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, H, hd, N)
    np.testing.assert_allclose(as_np(y), as_np(jy), **STATE_TOL)
    np.testing.assert_allclose(as_np(h), as_np(jh), **STATE_TOL)
    # the sequential oracles agree too, from the same initial state
    ry, rh = jssm.ssd_reference(*map(J, arrs), initial_state=J(h0),
                                return_state=True)
    ty, th = ssm.ssd_reference(*map(T, arrs), initial_state=T(h0),
                               return_state=True)
    np.testing.assert_allclose(as_np(ty), as_np(ry), **FN_TOL)
    np.testing.assert_allclose(as_np(th), as_np(rh), **FN_TOL)
    np.testing.assert_allclose(as_np(h), as_np(rh), **SWEEP_TOL)


def test_state_carry_two_halves_equal_one_run():
    """The port's mirror of ``tests/test_models.py::test_ssd_state_carry``."""
    arrs, _ = make_ssd(1, 40, 2, 8, 4, 1, seed=2)
    x, dt, A, Bm, Cm = map(T, arrs)
    full, h_full = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=8, return_state=True)
    h = 40 // 2
    y1, st = ssd_scan_plain(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h],
                            chunk=8, return_state=True)
    y2, h2 = ssd_scan_plain(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:],
                            chunk=8, initial_state=st, return_state=True)
    np.testing.assert_allclose(as_np(torch.cat([y1, y2], 1)), as_np(full),
                               **CARRY_TOL)
    np.testing.assert_allclose(as_np(h2), as_np(h_full), **CARRY_TOL)
    # the same split through the JAX package
    jx, jdt, jA, jB, jC = map(J, arrs)
    _, jst = jssm.ssd_chunked(jx[:, :h], jdt[:, :h], jA, jB[:, :h], jC[:, :h],
                              chunk=8, return_state=True)
    np.testing.assert_allclose(as_np(st), as_np(jst), **STATE_TOL)


def test_bf16_inputs_match_jax_ssd_chunked():
    arrs, h0 = make_ssd(2, 100, 4, 16, 8, 2, seed=3, state=True)
    x, dt, A, Bm, Cm = arrs
    b = torch.bfloat16
    y, h = ssd_scan_plain(T(x, b), T(dt), T(A), T(Bm, b), T(Cm, b),
                          initial_state=T(h0), return_state=True)
    jb = jnp.bfloat16
    jy, jh = jssm.ssd_chunked(J(x, jb), J(dt), J(A), J(Bm, jb), J(Cm, jb),
                              initial_state=J(h0), return_state=True)
    assert y.dtype == b and h.dtype == torch.float32
    np.testing.assert_allclose(as_np(y), as_np(jy), **BF16_TOL)
    np.testing.assert_allclose(as_np(h), as_np(jh), **BF16_TOL)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_result_does_not_depend_on_the_chunk(chunk):
    arrs, h0 = make_ssd(2, 150, 4, 16, 8, 2, seed=4, state=True)
    ref_y, ref_h = ssm.ssd_reference(*map(T, arrs), initial_state=T(h0),
                                     return_state=True)
    y, h = ssd_scan_plain(*map(T, arrs), initial_state=T(h0),
                          return_state=True, chunk=chunk)
    np.testing.assert_allclose(as_np(y), as_np(ref_y), **CARRY_TOL)
    np.testing.assert_allclose(as_np(h), as_np(ref_h), **CARRY_TOL)
    # ssd_chunked is the same function under its JAX name and default chunk
    cy, ch = ssm.ssd_chunked(*map(T, arrs), initial_state=T(h0),
                             return_state=True, chunk=chunk)
    assert torch.equal(cy, y) and torch.equal(ch, h)


def test_steep_decays_stay_finite():
    """dt*A near -16 a token (the model's largest |A|): exp(cs) underflows
    to 0 across a chunk, which must not become NaN."""
    arrs, _ = make_ssd(1, 140, 3, 16, 8, 1, seed=5)
    x, dt, A, Bm, Cm = arrs
    A = np.array([-16.0, -1.0, -16.0], np.float32)
    dt = dt * 8.0
    y, h = ssd_scan_plain(*map(T, (x, dt, A, Bm, Cm)), return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    ry, rh = jssm.ssd_reference(*map(J, (x, dt, A, Bm, Cm)), return_state=True)
    np.testing.assert_allclose(as_np(y), as_np(ry), **SWEEP_TOL)
    np.testing.assert_allclose(as_np(h), as_np(rh), **SWEEP_TOL)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def test_ops_ssd_on_cpu_takes_the_plain_version_and_launches_nothing():
    arrs, h0 = make_ssd(2, 70, 4, 16, 8, 2, seed=6, state=True)
    before = ssd_scan.launches
    y, h = ops.ssd(*map(T, arrs), initial_state=T(h0), return_state=True)
    assert ssd_scan.launches == before
    py, ph = ssd_scan_plain(*map(T, arrs), initial_state=T(h0), return_state=True)
    assert torch.equal(y, py) and torch.equal(h, ph)
    assert torch.equal(ops.ssd(*map(T, arrs), impl="plain"), ssd_scan_plain(*map(T, arrs)))
    # the JAX dispatch, both routes, on the same inputs
    for use_pallas in (False, True):
        ref = jops.ssd(*map(J, arrs), use_pallas=use_pallas)
        np.testing.assert_allclose(as_np(ops.ssd(*map(T, arrs))), as_np(ref),
                                   **SWEEP_TOL)


def test_ops_ssd_kernel_on_cpu_raises():
    arrs, h0 = make_ssd(1, 16, 2, 16, 8, 1, seed=7, state=True)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(*map(T, arrs), impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*map(T, arrs), initial_state=T(h0), return_state=True)
    with pytest.raises(ValueError, match="impl"):
        ops.ssd(*map(T, arrs), impl="pallas")
    assert ssd_scan.launches == before      # nothing was launched


# --------------------------------------------------------------------------
# the Mamba2 mixer
# --------------------------------------------------------------------------

def test_segsum_matches_jax():
    la = -np.abs(np.random.default_rng(8).standard_normal((2, 3, 12))).astype(np.float32)
    out, ref = as_np(ssm._segsum(T(la))), as_np(jssm._segsum(J(la)))
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], **FN_TOL)


@pytest.mark.parametrize("S", [1, 2, 9])
@pytest.mark.parametrize("with_lag", [False, True])
def test_causal_conv_matches_jax(S, with_lag):
    rng = np.random.default_rng(9)
    K, C, B = 4, 24, 2
    xBC = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32) * 0.5
    b = rng.standard_normal(C).astype(np.float32) * 0.1
    lag = rng.standard_normal((B, K - 1, C)).astype(np.float32) if with_lag else None
    out, new_lag = ssm._causal_conv(T(xBC), T(w), T(b),
                                    T(lag) if with_lag else None)
    ref, ref_lag = jssm._causal_conv(J(xBC), J(w), J(b),
                                     J(lag) if with_lag else None)
    np.testing.assert_allclose(as_np(out), as_np(ref), **FN_TOL)
    np.testing.assert_array_equal(as_np(new_lag), as_np(ref_lag))
    assert tuple(new_lag.shape) == (B, K - 1, C)


def mamba2_params(arch="mamba2-1.3b", seed=0):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp, _ = jmod.split(jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg))
    # make the zero-initialised conv bias count
    jp["conv_b"] = jnp.asarray(np.random.default_rng(10).standard_normal(
        jp["conv_b"].shape).astype(np.float32) * 0.1)
    tp = {k: T(np.asarray(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def test_init_mamba2_has_the_reference_names_shapes_and_decays():
    jcfg, cfg, jp, _ = mamba2_params()
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    np.testing.assert_allclose(as_np(p["a_log"]), as_np(jp["a_log"]), **FN_TOL)
    # dt = softplus(dt_bias) lies in [1e-3, 0.1], as the reference draws it
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert torch.equal(p["conv_b"], torch.zeros_like(p["conv_b"]))
    st, jst = ssm.init_ssm_state(cfg, 3, device="cpu"), jssm.init_ssm_state(jcfg, 3)
    assert tuple(st.h.shape) == jst.h.shape and st.h.dtype == torch.float32
    assert tuple(st.conv.shape) == jst.conv.shape


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_mamba2_forward_prefill_then_decode_matches_jax(arch):
    jcfg, cfg, jp, tp = mamba2_params(arch, seed=1)
    rng = np.random.default_rng(11)
    B, S, steps = 2, 37, 3
    u = rng.standard_normal((B, S + steps, cfg.d_model)).astype(np.float32)
    jout, jst = jssm.mamba2_forward(jp, J(u[:, :S]), jcfg, return_state=True)
    out, st = ssm.mamba2_forward(tp, T(u[:, :S]), cfg, return_state=True)
    np.testing.assert_allclose(as_np(out), as_np(jout), **FN_TOL)
    np.testing.assert_allclose(as_np(st.h), as_np(jst.h), **FN_TOL)
    np.testing.assert_allclose(as_np(st.conv), as_np(jst.conv), **FN_TOL)
    assert as_np(out).std() > 1e-3                       # not a trivial output
    for t in range(S, S + steps):                        # S == 1: O(1) recurrence
        jout, jst = jssm.mamba2_forward(jp, J(u[:, t:t + 1]), jcfg, state=jst,
                                        return_state=True)
        out, st = ssm.mamba2_forward(tp, T(u[:, t:t + 1]), cfg, state=st,
                                     return_state=True)
        np.testing.assert_allclose(as_np(out), as_np(jout), **FN_TOL)
        np.testing.assert_allclose(as_np(st.h), as_np(jst.h), **FN_TOL)
        np.testing.assert_allclose(as_np(st.conv), as_np(jst.conv), **FN_TOL)
    # a prefill that starts from a state (S > 1 with a state) as well
    jout, _ = jssm.mamba2_forward(jp, J(u[:, :5]), jcfg, state=jst,
                                  return_state=True)
    out, _ = ssm.mamba2_forward(tp, T(u[:, :5]), cfg, state=st,
                                return_state=True)
    np.testing.assert_allclose(as_np(out), as_np(jout), **FN_TOL)


def test_mamba2_forward_without_state_returns_the_output_alone():
    jcfg, cfg, jp, tp = mamba2_params(seed=2)
    u = np.random.default_rng(12).standard_normal((1, 6, cfg.d_model)).astype(np.float32)
    out = ssm.mamba2_forward(tp, T(u), cfg)
    np.testing.assert_allclose(as_np(out), as_np(jssm.mamba2_forward(jp, J(u), jcfg)),
                               **FN_TOL)
