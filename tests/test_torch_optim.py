"""The port's AdamW (``repro_torch.train.optim``) on the CPU against the JAX
package's (``repro.train.optim``) on the same numpy parameters and gradients,
and five whole train steps of the port (``parallel.steps.make_train_step``)
against JAX's ``value_and_grad`` + ``adam_update`` on converted weights.

Tolerances, fp32 on both sides: rtol 1e-5 / atol 1e-7 on parameters and
moments (the same arithmetic; XLA and PyTorch may round a fused
multiply-add differently).  int8 moments are compared after dequantising, to
one quantum of their row (a division one ulp apart can move a value across a
rounding boundary); bf16 moments to one bf16 ulp.  Five train steps: the
loss trajectory to rtol 1e-4 and the parameters after step 5 to relative 1e-4
(``rel_close``), with Adam's eps at 1e-6 (the test says why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import modules as jmod
from repro.models import transformer as jtfm
from repro.models.config import ParallelConfig as JParallelConfig
from repro.train import optim as jopt

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.models.config import ParallelConfig
from repro_torch.parallel.steps import TrainState, make_train_step
from repro_torch.train import data, optim

FP_TOL = dict(rtol=1e-5, atol=1e-7)


def tree_np(rng):
    """A small parameter tree: a matrix, a vector, a 3-D leaf (per-row int8
    scales of shape (4, 3)) and a scalar-sized vector."""
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((4, 3, 8)).astype(np.float32)},
            "e": rng.standard_normal(1).astype(np.float32)}


def to_j(tree):
    return {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def to_t(tree):
    return {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def moment_np(x):
    if isinstance(x, (optim.QTensor, jopt.QTensor)):
        deq = optim._dequantize(x) if isinstance(x, optim.QTensor) else jopt._dequantize(x)
        return as_np(deq), as_np(x.scale)
    return as_np(x), None


def test_optim_config_copy_equals_jax():
    assert dataclasses.asdict(optim.OptimConfig()) == dataclasses.asdict(jopt.OptimConfig())
    assert [f.name for f in dataclasses.fields(optim.OptimConfig)] == \
        [f.name for f in dataclasses.fields(jopt.OptimConfig)]


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", [(64, 256), (300,), (3, 5, 40)])
def test_quantize_matches_jax(signed, shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32) * 3.0
    if not signed:
        x = np.abs(x)
    tq = optim._quantize(torch.from_numpy(x), signed)
    jq = jopt._quantize(jnp.asarray(x), signed)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert tuple(tq.scale.shape) == tuple(jq.scale.shape) == shape[:-1]
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale), rtol=1e-7)
    # at most one value in a thousand one step apart (a division one ulp off)
    diff = np.abs(tq.q.numpy().astype(int) - np.asarray(jq.q).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(optim._dequantize(tq).numpy(),
                               np.asarray(jopt._dequantize(jq)),
                               atol=float(np.asarray(jq.scale).max()) * 1.001)


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32)) * 3
    q = optim._quantize(x, signed=True)
    err = (optim._dequantize(q) - x).abs().max()
    # per-row scale: at most half a quantum + the bf16 pre-cast rounding
    assert float(err) <= float(q.scale.max()) * 0.51 + 0.01 * float(x.abs().max())


@pytest.mark.parametrize("step", [0, 1, 5, 50, 99, 100, 101, 5000, 10_000, 20_000])
def test_lr_schedule_matches_jax(step):
    ocfg = optim.OptimConfig(lr=2e-3, warmup_steps=100, total_steps=10_000,
                             min_lr_ratio=0.1)
    jo = jopt.OptimConfig(lr=2e-3, warmup_steps=100, total_steps=10_000, min_lr_ratio=0.1)
    got = optim.lr_schedule(torch.tensor(step, dtype=torch.int32), ocfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jopt.lr_schedule(jnp.asarray(step), jo)),
                               rtol=1e-6)


def test_global_norm_matches_jax():
    t = tree_np(np.random.default_rng(1))
    np.testing.assert_allclose(float(optim.global_norm(to_t(t))),
                               float(jopt.global_norm(to_j(t))), rtol=1e-6)


def test_init_adam_mirrors_the_parameter_tree():
    p = to_t(tree_np(np.random.default_rng(2)))
    for mdt, master in (("float32", True), ("bfloat16", False), ("int8", True)):
        st = optim.init_adam(p, optim.OptimConfig(master=master, moments_dtype=mdt))
        assert int(st.step) == 0 and st.step.dtype == torch.int32
        assert (st.master is not None) == master
        if master:   # a copy, never the parameter itself
            assert st.master["a"].data_ptr() != p["a"].data_ptr()
            assert torch.equal(st.master["a"], p["a"])
        m = st.m["b"]["d"]
        if mdt == "int8":
            assert m.q.dtype == torch.int8 and tuple(m.scale.shape) == (4, 3)
        else:
            assert m.dtype == getattr(torch, mdt) and not m.any()


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("master", [True, False])
def test_adam_update_matches_jax(moments, master):
    """Three steps with clipping active, warmup and weight decay, from the
    same parameters and gradients."""
    rng = np.random.default_rng(4)
    p_np = tree_np(rng)
    grads = [tree_np(rng) for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=2.0,
              weight_decay=0.1, master=master, moments_dtype=moments)
    tcfg, jcfg = optim.OptimConfig(**kw), jopt.OptimConfig(**kw)
    tp, jp = to_t(p_np), to_j(p_np)
    ts, js = optim.init_adam(tp, tcfg), jopt.init_adam(jp, jcfg)
    for g in grads:
        out_p, ts, tm = optim.adam_update(tp, to_t(g), ts, tcfg)
        assert out_p is tp                                  # updated in place
        jp, js, jm = jopt.adam_update(jp, to_j(g), js, jcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(leaves(tp), leaves(jp)):
        np.testing.assert_allclose(as_np(a), as_np(b), **FP_TOL)
    if master:
        for a, b in zip(leaves(ts.master), leaves(js.master)):
            np.testing.assert_allclose(as_np(a), as_np(b), **FP_TOL)
    is_q = lambda x: isinstance(x, (optim.QTensor, jopt.QTensor))   # noqa: E731
    for tt, jt in ((ts.m, js.m), (ts.v, js.v)):
        for path in (("a",), ("b", "c"), ("b", "d"), ("e",)):
            a, b = tt, jt
            for key in path:
                a, b = a[key], b[key]
            assert is_q(a) == is_q(b)
            (av, ascale), (bv, _) = moment_np(a), moment_np(b)
            if moments == "int8":
                tol = dict(rtol=1e-5, atol=float(ascale.max()) * 1.001)
            elif moments == "bfloat16":
                tol = dict(rtol=2 ** -7, atol=1e-12)
            else:
                tol = FP_TOL
            np.testing.assert_allclose(av, bv, **tol)


def test_adam_matches_manual_reference():
    ocfg = optim.OptimConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                             grad_clip=0.0, warmup_steps=0, total_steps=10**9)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = optim.init_adam(p, ocfg)
    newp, state, _ = optim.adam_update(p, g, state, ocfg)
    m = 0.1 * g["w"].numpy()
    v = 0.01 * g["w"].numpy() ** 2
    upd = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
    ref = np.array([1.0, -2.0, 3.0]) - 0.1 * upd
    np.testing.assert_allclose(newp["w"].numpy(), ref, rtol=1e-5)


def test_grad_clip_caps_global_norm():
    ocfg = optim.OptimConfig(lr=1.0, grad_clip=1.0, warmup_steps=0, weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}   # norm 200
    state = optim.init_adam(p, ocfg)
    _, state2, metrics = optim.adam_update(p, g, state, ocfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # the m update used the clipped gradient: m = (1 - b1) * g / 200
    np.testing.assert_allclose(state2.m["w"].numpy(), np.full(4, 0.1 * 100.0 / 200.0),
                               rtol=1e-4)


@pytest.mark.parametrize("mdtype", ["float32", "bfloat16", "int8"])
def test_adam_converges_quadratic(mdtype):
    """min ||w - w*||² under each moments mode (the reference's test)."""
    ocfg = optim.OptimConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0,
                             warmup_steps=0, total_steps=10**9,
                             master=(mdtype != "int8"), moments_dtype=mdtype)
    target = torch.tensor([1.0, -0.5, 2.0, 0.25] * 64)
    p = {"w": torch.zeros(256)}
    state = optim.init_adam(p, ocfg)
    for _ in range(400):
        p, state, _ = optim.adam_update(p, {"w": 2 * (p["w"] - target)}, state, ocfg)
    err = float((p["w"] - target).abs().max())
    assert err < (0.05 if mdtype == "int8" else 0.01), f"{mdtype}: {err}"


def test_bf16_params_with_fp32_master_round_once_per_step():
    """master=True keeps the fp32 master; the bf16 parameter is its rounding."""
    ocfg = optim.OptimConfig(lr=1e-3, warmup_steps=0, master=True)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 16)).astype(np.float32))
    p = {"w": w.to(torch.bfloat16)}
    state = optim.init_adam(p, ocfg)
    for s in range(3):
        g = {"w": torch.full((8, 16), 0.5 * (s + 1), dtype=torch.bfloat16)}
        p, state, _ = optim.adam_update(p, g, state, ocfg)
        assert p["w"].dtype == torch.bfloat16
        assert torch.equal(p["w"], state.master["w"].to(torch.bfloat16))


# --------------------------------------------------------------------------
# five train steps against JAX's value_and_grad + adam_update
# --------------------------------------------------------------------------

DENSE = ["llama3.2-1b", "qwen3-32b", "qwen1.5-4b", "chatglm3-6b"]


def rel_close(got, want, rel=1e-4, what=""):
    """Every element within ``rel`` of the leaf's largest magnitude, and the
    leaf's Frobenius error within ``rel`` of its norm."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)
    fro = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert fro <= rel, f"{what}: Frobenius relative error {fro:.3e}"


def leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def converted(arch, seed=0):
    """Reduced configuration, JAX weights (biases and qk-norms made to count)
    and the port's conversion of them."""
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jv, _ = jmod.split(jtfm.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(40)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in jv["blocks"].get("attn", {}):
            a = jv["blocks"]["attn"][name]
            base = 1.0 if name.endswith("norm") else 0.0
            jv["blocks"]["attn"][name] = jnp.asarray(
                base + 0.1 * rng.standard_normal(a.shape).astype(np.float32))
    tp = from_jax_params(jax.tree.map(np.asarray, jv), cfg, device="cpu")
    return jcfg, cfg, jv, tp


@pytest.mark.parametrize("arch", DENSE + ["mamba2-1.3b", "arctic-480b", "mixtral-8x7b"])
def test_five_train_steps_match_jax(arch):
    """Adam's eps is 1e-6 here, not the default 1e-8.  Adam divides by
    sqrt(v), so a gradient component that is zero in exact arithmetic moves
    its parameter by about lr with the sign of its rounding noise (chatglm's
    k bias on the half of the head that RoPE leaves alone: softmax ignores
    it, and 15 of its 64 gradient components differ in sign between the two
    packages, at 1e-10 against a leaf maximum near 1e-2).  The update's
    sensitivity to such noise is at most 1/eps; with 1e-6 a gradient error of
    1e-8 moves a parameter by at most 3e-5 of lr 3e-3 and the comparison is
    well posed.  Measured worst after five steps: 3.5e-5 elementwise (of the
    leaf's largest magnitude), 6.1e-6 Frobenius; with eps 1e-8 up to 9.3e-4
    and 5.4e-4, all of it in such components."""
    jcfg, cfg, jv, tp = converted(arch)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-6)
    jocfg, ocfg = jopt.OptimConfig(**kw), optim.OptimConfig(**kw)
    src = data.SyntheticLM(data.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                           global_batch=2, seed=5))

    @jax.jit
    def jstep(params, opt, batch):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jtfm.loss_fn(p, batch, jcfg, JParallelConfig(remat="none")),
            has_aux=True)(params)
        params, opt, om = jopt.adam_update(params, grads, opt, jocfg)
        return params, opt, {**metrics, **om}

    jp, jo = jv, jopt.init_adam(jv, jocfg)
    state = TrainState(tp, optim.init_adam(tp, ocfg))
    step = make_train_step(cfg, ParallelConfig(remat="none"), ocfg)
    j_losses, t_losses = [], []
    for i in range(5):
        batch = src.batch(i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm = step(state, batch)
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert state.params is tp                      # updated in place
    assert int(state.opt.step) == 5
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jp)))
    got = dict(leaves_with_paths(to_jax_params(state.params, cfg)))
    for path in want:
        rel_close(got[path], want[path], 1e-4, "/".join(path))
