"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) on the CPU
against the JAX package's ``repro.models.moe``, function by function, on the
same numpy inputs and weights, fp32.

Tolerances: integer outputs (expert ids, bucket slots) and the routing
decisions bit for bit; the router's probabilities, combine weights and aux
loss atol 1e-6 / rtol 1e-5 (the same fp32 softmax, sums in another order);
the FFN's output and every gradient atol 1e-5 / rtol 1e-4 (three products of
fp32 values in another order).  The invariants of ``tests/test_moe_optim.py``
(dispatch slots, dropless = the dense expert sum, a uniform router's aux = 1)
are held on the port's functions, with a fixed grid of cases in place of
hypothesis' draws.  The three-level parameter tree (arctic's
``ffn.dense.*``) goes through the converter and the checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import modules as jmod
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.train import checkpoint as jckpt

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.models import modules, moe
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import OptimConfig, init_adam

MOE = ["arctic-480b", "mixtral-8x7b"]
PROB_TOL = dict(atol=1e-6, rtol=1e-5)
FFN_TOL = dict(atol=1e-5, rtol=1e-4)


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def as_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_moe_params(arch, seed=0, **overrides):
    """Reduced configuration (both packages) and the JAX ``init_moe`` weights,
    as numpy and as the port's tensors."""
    jcfg = j_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jp, _ = jmod.split(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    jp = jax.tree.map(np.asarray, jp)
    tp = modules.tree_map(lambda a: torch.tensor(a), jp)
    return jcfg, cfg, jp, tp


# --------------------------------------------------------------------------
# routing and dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (128, 2), (6, 1)])
def test_route_matches_jax(E, k):
    x, w = rnd((3, 40, 32), 1), rnd((32, E), 2, 0.5)
    idx, cw, aux = moe._route(T(x), T(w), E, k)
    for g in range(3):
        jidx, jcw, jaux = jmoe._route(jnp.asarray(x[g]), jnp.asarray(w), E, k)
        np.testing.assert_array_equal(idx[g].numpy(), np.asarray(jidx))
        np.testing.assert_allclose(as_np(cw[g]), np.asarray(jcw), **PROB_TOL)
        np.testing.assert_allclose(float(aux[g]), float(jaux), **PROB_TOL)
    assert idx.dtype == torch.int64 and cw.dtype == torch.float32


def test_route_breaks_ties_to_the_lower_expert_like_lax_top_k():
    """A zero router gives every expert the same probability: jax.lax.top_k
    takes the lowest indices, and so does the port's stable sort (torch.topk
    promises no order among ties)."""
    x = T(rnd((16, 8), 3))
    idx, cw, _ = moe._route(x, torch.zeros(8, 6), 6, 2)
    jidx, _, _ = jmoe._route(jnp.asarray(x.numpy()), jnp.zeros((8, 6)), 6, 2)
    assert (idx == torch.tensor([0, 1])).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert torch.equal(cw, torch.full((16, 2), 0.5))
    # a tie between the 2nd and 3rd choice only: expert 1 wins over expert 3
    w = torch.zeros(8, 4)
    w[:, 0] = 1.0
    x1 = torch.ones(1, 8)
    assert moe._route(x1, w, 4, 2)[0].tolist() == [[0, 1]]
    assert np.asarray(jmoe._route(jnp.ones((1, 8)), jnp.asarray(w.numpy()), 4, 2)[0]
                      ).tolist() == [[0, 1]]


@pytest.mark.parametrize("T_,E,k,cap", [(4, 2, 1, 2), (64, 8, 2, 16), (64, 8, 2, 4),
                                        (37, 5, 2, 7), (100, 128, 2, 4), (16, 4, 2, 100)])
def test_dispatch_indices_match_jax(T_, E, k, cap):
    idx = np.random.default_rng(T_ + E).integers(0, E, (3, T_, k))
    slot = moe._dispatch_indices(T(idx), E, cap)
    for g in range(3):
        np.testing.assert_array_equal(
            slot[g].numpy(), np.asarray(jmoe._dispatch_indices(jnp.asarray(idx[g]), E, cap)))


@pytest.mark.parametrize("T_,E,k,cap,seed", [(4, 2, 1, 2, 0), (64, 8, 2, 16, 1),
                                             (64, 8, 2, 3, 2), (33, 5, 2, 7, 3),
                                             (50, 3, 1, 16, 4), (12, 8, 2, 2, 5)])
def test_dispatch_slots(T_, E, k, cap, seed):
    """``tests/test_moe_optim.py::test_dispatch_slots`` on the port: kept slots
    are unique, lie in their expert's bucket, and no bucket holds more than
    its capacity; a choice is dropped only when its bucket is full."""
    idx = torch.from_numpy(np.random.default_rng(seed).integers(0, E, (T_, k)))
    slot = moe._dispatch_indices(idx, E, cap)
    kept = slot[slot >= 0]
    assert len(torch.unique(kept)) == len(kept)
    experts, pos = kept // cap, kept % cap
    assert (pos < cap).all()
    assert torch.equal(torch.sort(experts).values,
                       torch.sort(idx.reshape(-1)[slot.reshape(-1) >= 0]).values)
    for e in range(E):
        n = int((idx == e).sum())
        assert int((experts == e).sum()) == min(n, cap)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_group_dispatch_and_combine_match_jax(arch, cf):
    jcfg, cfg, jp, tp = jax_moe_params(arch)
    E, k = cfg.n_experts, cfg.top_k
    G, T_, d = 3, 24, cfg.d_model
    cap = moe.capacity_of(T_, dataclasses.replace(cfg, capacity_factor=cf))
    x = rnd((G, T_, d), 4)
    b, fs, cw, aux = moe._group_dispatch(T(x), tp["router"], E, k, cap)
    jb, jfs, jcw, jaux = jax.vmap(lambda t: jmoe._group_dispatch(
        t, jnp.asarray(jp["router"]), E, k, cap))(jnp.asarray(x))
    assert tuple(b.shape) == (G, E, cap, d)
    np.testing.assert_array_equal(as_np(b), np.asarray(jb))     # copies of the tokens
    np.testing.assert_array_equal(fs.numpy(), np.asarray(jfs))
    np.testing.assert_allclose(as_np(cw), np.asarray(jcw), **PROB_TOL)
    np.testing.assert_allclose(as_np(aux), np.asarray(jaux), **PROB_TOL)
    if cf == 0.5:
        assert int((fs < 0).sum()) > 0          # this case drops
    y = rnd((G, E * cap, d), 5)
    out = moe._group_combine(T(y), fs, cw, T_, k)
    jout = jax.vmap(lambda ye, f, c: jmoe._group_combine(ye, f, c, T_, k))(
        jnp.asarray(y), jfs, jcw)
    np.testing.assert_allclose(as_np(out), np.asarray(jout), **FFN_TOL)


# --------------------------------------------------------------------------
# the FFN and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [None, 0.5, 16.0], ids=["cf1.25", "cf0.5-drops", "dropless"])
def test_moe_ffn_and_grads_match_jax(arch, cf):
    """Output, aux and the gradient of ``sum(out * ct) + aux`` with respect to
    every weight (router, experts, arctic's dense residual) and the input,
    against ``jax.grad`` of JAX ``moe_ffn``."""
    jcfg, cfg, jp, tp = jax_moe_params(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x, ct = rnd((2, 20, cfg.d_model), 6), rnd((2, 20, cfg.d_model), 7)
    leaves, spec = modules.tree_flatten(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    xt = T(x).requires_grad_()
    out, aux = moe.moe_ffn(modules.tree_unflatten(spec, live), xt, cfg)
    ((out * T(ct)).sum() + aux).backward()

    def jloss(p, xx):
        o, a = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(o * ct) + a, (o, a)
    (_, (jo, ja)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    np.testing.assert_allclose(as_np(out), np.asarray(jo), **FFN_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ja), **PROB_TOL)
    np.testing.assert_allclose(as_np(xt.grad), np.asarray(jgx), **FFN_TOL)
    got = modules.tree_unflatten(spec, [t.grad for t in live])
    want = jax.tree.map(np.asarray, jg)
    assert ("dense" in got) == bool(cfg.moe_dense_ff)
    for path, g in zip(*_paths(got)):
        np.testing.assert_allclose(as_np(g), _at(want, path), **FFN_TOL,
                                   err_msg="/".join(path))


def _paths(tree, path=()):
    paths, leaves = [], []
    for name in sorted(tree):
        if isinstance(tree[name], dict):
            p, l = _paths(tree[name], path + (name,))
            paths += p
            leaves += l
        else:
            paths.append(path + (name,))
            leaves.append(tree[name])
    return paths, leaves


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dropless_moe_equals_dense_expert_sum(seed):
    """``tests/test_moe_optim.py::test_dropless_moe_equals_dense_expert_sum``
    on the port: with a capacity no bucket can fill, the FFN is the explicit
    top-k mixture of each token's experts."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), capacity_factor=32.0)
    p = moe.init_moe(torch.Generator().manual_seed(seed), cfg, device="cpu")
    x = torch.from_numpy(rnd((2, 8, cfg.d_model), seed + 10, 0.3))
    out, _ = moe.moe_ffn(p, x, cfg)
    x2d = x.reshape(-1, cfg.d_model)
    eidx, cw, _ = moe._route(x2d, p["router"], cfg.n_experts, cfg.top_k)
    ref = torch.zeros_like(x2d)
    for t in range(x2d.shape[0]):
        for j in range(cfg.top_k):
            e = int(eidx[t, j])
            h = modules.swiglu(x2d[t] @ p["w_gate"][e], x2d[t] @ p["w_up"][e])
            ref[t] += cw[t, j] * (h @ p["w_down"][e])
    np.testing.assert_allclose(as_np(out.reshape(-1, cfg.d_model)), as_np(ref),
                               atol=2e-4, rtol=2e-3)


def test_aux_loss_uniform_router_is_one():
    """A uniform router (zero weights) spreads the choices evenly: the Switch
    aux loss is 1, as in ``tests/test_moe_optim.py``; in the port's exact
    tie-breaking every token picks experts 0 and 1, so frac_tokens is 1/2 on
    those and aux = E * (1/2 * 1/E) * 2 = 1 exactly."""
    x = torch.from_numpy(rnd((4096, 16), 8))
    _, _, aux = moe._route(x, torch.zeros(16, 8), 8, 2)
    assert float(aux) == pytest.approx(1.0, rel=1e-6)
    _, _, jaux = jmoe._route(jnp.asarray(x.numpy()), jnp.zeros((16, 8)), 8, 2)
    assert float(jaux) == pytest.approx(float(aux), rel=1e-6)


def test_capacity_rule_matches_jax_moe_ffn():
    """max(ceil(T_g k cf / E), 4) rounded up to a multiple of 4, T_g = S
    (one group a sequence), cf = ``cfg.capacity_factor``."""
    for arch, T_, cf in (("mixtral-8x7b", 20, None), ("arctic-480b", 20, None),
                         ("mixtral-8x7b", 3, None), ("arctic-480b", 100, 0.5)):
        cfg = get_config(arch).reduced()
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        want = max(int(np.ceil(T_ * cfg.top_k * cfg.capacity_factor
                               / cfg.n_experts)), 4)
        assert moe.capacity_of(T_, cfg) == -(-want // 4) * 4
    assert moe.capacity_of(2048, get_config("mixtral-8x7b")) == 640
    assert moe.capacity_of(2048, get_config("arctic-480b")) == 40


def test_init_moe_shapes_and_expert_fan_in():
    """The JAX names and shapes; each expert stack drawn with the JAX fan-in
    of a 3-D shape (E x d for w_gate / w_up, E x f for w_down)."""
    cfg = get_config("arctic-480b").reduced()
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp, _ = jmod.split(jmoe.init_moe(jax.random.PRNGKey(0), j_get_config("arctic-480b").reduced()))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert modules.tree_map(lambda t: tuple(t.shape), p) == shapes
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert float(p["w_gate"].abs().max()) <= 2.0 / np.sqrt(E * d) + 1e-7
    assert float(p["w_down"].abs().max()) <= 2.0 / np.sqrt(E * f) + 1e-7
    assert float(p["router"].abs().max()) <= 0.04 + 1e-7
    assert p["w_up"].dtype == torch.float32
    bf = moe.init_moe(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16, device="cpu")
    assert bf["w_down"].dtype == torch.bfloat16 and bf["dense"]["w_up"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the three-level tree: converter and checkpoint
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_to_jax_params_inverts_from_jax_params_for_moe(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jv, _ = jmod.split(jtfm.init(jax.random.PRNGKey(0), jcfg))
    vals = jax.tree.map(np.asarray, jv)
    tp = from_jax_params(vals, cfg, device="cpu")
    assert len(tp["blocks"]) == cfg.num_layers
    ffn = tp["blocks"][1]["ffn"]
    np.testing.assert_array_equal(as_np(ffn["w_down"]), vals["blocks"]["ffn"]["w_down"][1])
    if cfg.moe_dense_ff:
        np.testing.assert_array_equal(as_np(ffn["dense"]["w_gate"]),
                                      vals["blocks"]["ffn"]["dense"]["w_gate"][1])
    back = to_jax_params(tp, cfg)
    want = jax.tree_util.tree_flatten_with_path(vals)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrips_the_three_level_moe_state(tmp_path):
    """Reduced arctic's parameters and AdamW state (bf16 params, fp32 master
    and moments) saved and restored bit for bit; the JAX package's ``restore``
    reads the saved ``ffn`` subtree of a layer (router, experts, the dense
    residual one level down) from a port save of it."""
    cfg = get_config("arctic-480b").reduced()
    params = tfm.init(0, cfg, dtype=torch.bfloat16, device="cpu")
    state = {"params": params, "opt": init_adam(params, OptimConfig())}
    ckpt.save(tmp_path / "state", state, step=5, extras={"step": 5})
    target = modules.tree_map(torch.zeros_like, state["params"])
    target = {"params": target, "opt": init_adam(target, OptimConfig())}
    restored, extras = ckpt.restore(tmp_path / "state", target)
    assert extras["step"] == 5
    for a, b in zip(modules.tree_flatten(restored)[0], modules.tree_flatten(state)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ffn = modules.tree_map(lambda t: t.float(), params["blocks"][0]["ffn"])
    ckpt.save(tmp_path / "ffn", ffn, step=1)
    jtarget = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape)), ffn)
    jrestored, _ = jckpt.restore(tmp_path / "ffn", jtarget)
    assert set(jrestored["dense"]) == {"w_gate", "w_up", "w_down"}
    for path, g in zip(*_paths(ffn)):
        np.testing.assert_array_equal(np.asarray(_at(jrestored, path)), g.numpy())
