"""Heads that do not divide the TP degree, and the flash-decoding layout of
the decode caches, on the CPU, at reduced size, fp32 (``parallel.tp``:
``TPContext.head_ranges``, ``gather_parts``, ``flash_decode``,
``KVSeqContext``; ``models.layers._attention_tp_padded``; the setups of
``parallel.steps``), on weights converted from the JAX parameters
(``convert.py``).

References:

(i)   The combine (``KVSeqContext.attend``, the three sums of
      ``flash_decode``) against the one-device ``decode_attention`` on the
      whole cache: fp32 within ``FP32_SUM_ULPS`` eps of the sum of the
      magnitudes it adds (``sum_order_bound``), each fp32 route also that
      close to the float64 result of the same formula; bf16 within the
      reference's kernel tolerance for bf16 (atol 2e-2 / rtol 2e-2); cases:
      a cache whose length does not divide the ranks, a rank with no valid
      slot, the window, ranks over two axes.
(ii)  The setups against the one-device ``make_train_step`` / ``prefill`` /
      ``decode_step`` (``tests/test_torch_tp.py``'s tolerances: loss 1e-5
      relative, every synced gradient leaf and updated parameter 1e-5
      absolute, logits ``MODEL_TOL``, the decode state after the prefill
      ``STATE_TOL``, the caches compared on their logical slots), under
      replicated, zero1 and fsdp with block remat: ``reduced()`` (4 query /
      2 KV heads) over data 1 x model 4 for the dense (llama3.2-1b,
      qwen1.5-4b with its bias, qwen3-32b with qk-norm, chatglm3-6b), vlm,
      audio (the cross cache replicated), moe (mixtral-8x7b, its window of
      16 under a prompt of 20) and hybrid (zamba2-2.7b's shared block; its
      SSM heads divide) families; ``reduced(n_heads=3, n_kv_heads=1)`` (a
      rank holds 1.5 query heads' columns, half a KV head's; rank 1 one
      padded head) and ``reduced(n_heads=6, n_kv_heads=3)`` over data 2 x
      model 2, and mixtral's 6 / 3 with its experts over data
      (``moe_ep_axis``); serving at B 8 and at B 1, which no data axis
      divides (the caches' sequence over every axis).
(iii) The tree-reduce launches of a step, a prefill and a decode step against
      ``chip_smoke.py::tp_tree_launches`` (the count asserted on the card),
      the flash calls at a rank's padded heads.
(iv)  The port's (4, 2) ``data`` / ``model`` setups against the JAX setups on
      8 host devices (one module-scoped subprocess): an fsdp step, and a
      prefill with 3 decode steps at B 8 and at B 1, for the 3 / 1 and 6 / 3
      configs and mixtral's windowed 6 / 3.
(v)   A rank's decode-state bytes against the count from the layout.

The 4-rank ``gloo`` world of ``tests/test_torch_tp.py`` runs the 3 / 1
config too, bit-equal to the ``StackedMesh``.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import decode_attention
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel import tp as tpm
from repro_torch.parallel.steps import (TrainState, _enc_fn, batch_to_device, make_setup,
                                        make_train_setup, make_train_step, train_grads)
from repro_torch.train.optim import OptimConfig, init_adam

from tests.test_torch_setup import SRC, clone, leaves, nest
from tests.test_torch_tp import (MODEL_TOL, OCFG, STATE_TOL, Counting, config, jax_params,
                                 whole)

B, S, NEW = 8, 20, 3
MESHES = {"data1-model4": (1, 4), "data2-model2": (2, 2)}
SHARDINGS = ("replicated", "zero1", "fsdp")
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# fp32 eps a rounding of the combine may move an output by, in units of the
# sum of the magnitudes it adds (see ``sum_order_bound``)
FP32_SUM_ULPS = 8
ODD = {"h3kv1": dict(n_heads=3, n_kv_heads=1), "h6kv3": dict(n_heads=6, n_kv_heads=3)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (as the other
    setup test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params_of(arch, **kw):
    return from_jax_params(jax_params(arch, **kw), config(arch, **kw), device="cpu")


def make_batch(cfg, seed, batch=B):
    """Tokens and labels (batch, S), labels masked unevenly over the rows,
    and the family's patches or frames (0.02 N(0, 1))."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[rng.random((batch, S)) < np.arange(batch)[:, None] / 9] = -1
    out = {"tokens": toks[:, :-1].copy(), "labels": labels}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal((batch, cfg.n_patches, cfg.d_model))
                               * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((batch, cfg.enc_seq, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def serve_batch(cfg, batch=B, seed=11):
    inputs = {k: v for k, v in make_batch(cfg, seed, batch).items() if k != "labels"}
    rng = np.random.default_rng(seed + 1)
    return inputs, [rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
                    for _ in range(NEW)]


def cache_len(cfg):
    """The prompt (and patches) and NEW steps: 23 (31 with llava's patches),
    which 4 ranks do not divide (the storage pads it)."""
    return S + (cfg.n_patches if cfg.family == "vlm" else 0) + NEW


def mesh_of(name):
    return make_mesh(MESHES[name], ("data", "model"), device="cpu")


def train_setup(cfg, mesh_name, sharding, ep=""):
    pcfg = ParallelConfig(param_sharding=sharding, grad_sync="flat", remat="block",
                          moe_ep_axis=ep)
    return make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh_of(mesh_name), pcfg,
                            OptimConfig(**OCFG))


def serve_setups(cfg, mesh_name, sharding, batch=B, ep=""):
    pcfg = ParallelConfig(param_sharding=sharding, moe_ep_axis=ep)
    return [make_setup(cfg, ShapeConfig(k, k, cache_len(cfg), batch), mesh_of(mesh_name), pcfg)
            for k in ("prefill", "decode")]


# --------------------------------------------------------------------------
# (i) the combine
# --------------------------------------------------------------------------

COMBINE = {  # (mesh shape, axes, cache length, valid, window)
    "model4-ragged": ((4,), ("model",), 23, 17, 0),
    "model4-rank-without-a-slot": ((4,), ("model",), 24, 5, 0),
    "model4-window": ((4,), ("model",), 24, 20, 6),
    "model4-window-wrapped": ((4,), ("model",), 16, 16, 16),
    "data2-model2": ((2, 2), ("data", "model"), 21, 19, 0),
    "data2-model2-one-slot": ((2, 2), ("data", "model"), 21, 1, 0),
}


def decode_attention_f64(q, k, v, valid, window):
    """``decode_attention``'s formula in float64 on the same inputs, and the
    sum of the magnitudes its output adds, ``sum_j |p_j v_j| / denom``
    (B, 1, Hq, hd)."""
    B, _, Hq, hd = q.shape
    Hkv = k.shape[2]
    ok = torch.arange(k.shape[1]) < valid
    if window:
        ok &= torch.arange(k.shape[1]) >= valid - window
    qg = q.double().reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.double()) / math.sqrt(hd)
    w = torch.softmax(torch.where(ok, s, -math.inf), dim=-1)           # p / denom
    out = torch.einsum("bhgs,bshd->bhgd", w, v.double())
    mag = torch.einsum("bhgs,bshd->bhgd", w, v.double().abs())
    return out.reshape(B, 1, Hq, hd), mag.reshape(B, 1, Hq, hd)


def sum_order_bound(mag):
    """What the order of fp32 sums may change in an output element:
    ``FP32_SUM_ULPS`` eps times ``sum_j |p_j v_j| / denom`` (``mag``).

    The combine and ``decode_attention`` round the same operations and
    differ in the order of their sums: over the slots (the denominators and
    the values, blocked by rank in the combine) and over the head dim in
    the score products.  A sum's rounding is a multiple of eps times the sum
    of its terms' magnitudes, not times the result: an output of 0.01 that
    values of about 1 nearly cancel to moves by ulps of 1, which rtol 1e-6
    of the output could not hold.  The multiple, 8, counts the roundings on
    the path of each term in the two routes: its score sum, its exp, the
    denominator and the value sum, each once per route (2 x 4).  Each fp32
    route is held to the same bound against the float64 result."""
    return FP32_SUM_ULPS * torch.finfo(torch.float32).eps * mag


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", COMBINE)
def test_the_combine_equals_decode_attention(case, dtype):
    """Each rank's block of the cache, its partial statistics and the three
    sums give ``decode_attention`` of the whole cache; a rank whose whole
    block lies past the valid slots (or outside the window) adds exactly 0:
    its block may hold any finite values.  In fp32 both routes are first
    held to the float64 result, then to each other, within the bound that
    the order of their sums allows (``sum_order_bound``)."""
    shape, axes, length, valid, window = COMBINE[case]
    mesh = make_mesh(shape, axes, device="cpu")
    kvs = tpm.KVSeqContext(mesh, axes, length)
    gen = torch.Generator().manual_seed(4)
    Bq, Hq, Hkv, hd = 3, 6, 2, 16
    q = torch.randn(Bq, 1, Hq, hd, generator=gen).to(dtype)
    k = torch.randn(Bq, length, Hkv, hd, generator=gen).to(dtype)
    v = torch.randn(Bq, length, Hkv, hd, generator=gen).to(dtype)
    want = decode_attention(q, k, v, valid, window=window)
    k_buf, v_buf = kvs.place(k), kvs.place(v)
    assert k_buf.shape[1] == kvs.size * kvs.block >= length
    dead = torch.arange(k_buf.shape[1]) >= valid          # slots no query reads
    k_buf[:, dead] = 1e4
    v_buf[:, dead] = -1e4
    got = kvs.attend(q, k_buf, v_buf, valid, window)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        exact, mag = decode_attention_f64(q, k, v, valid, window)
        bound = sum_order_bound(mag)
        for route in (got, want):
            assert ((route.double() - exact).abs() <= bound).all()
        assert ((got.double() - want.double()).abs() <= bound).all()
    else:
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **BF16_TOL)


def test_the_combine_runs_its_sums_through_the_tree_reduce(monkeypatch):
    """Two tree reduces (the denominators, the values), the max an
    all-gather."""
    count = Counting(monkeypatch)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    kvs = tpm.KVSeqContext(mesh, ("data", "model"), 8)
    gen = torch.Generator().manual_seed(5)
    kv = torch.randn(1, 8, 1, 16, generator=gen)
    kvs.attend(torch.randn(1, 1, 2, 16, generator=gen), kvs.place(kv), kvs.place(kv), 6)
    assert count.reduce == 2


def test_the_head_ranges_pad_as_gspmd():
    """act_spec("q_heads")'s padding: ceil(H / tp) a rank, the tail short."""
    def ranges(n, tp):
        return tpm.TPContext(make_mesh((tp,), ("model",), device="meta"), "model").head_ranges(n)
    assert ranges(56, 16)[13:] == [(52, 56), (56, 56), (56, 56)]
    assert ranges(20, 8) == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 18), (18, 20),
                             (20, 20)]
    assert ranges(32, 16) == [(2 * i, 2 * i + 2) for i in range(16)]


def test_the_gather_of_parts_equals_their_gathers():
    """One gather of several parts of different shapes: each part's blocks
    put together, and each block's gradient its block of the rows' sum."""
    mesh = make_mesh((2,), ("model",), device="cpu")
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(2, 3, 4, 5, generator=gen, requires_grad=True)
    b = torch.randn(2, 3, 7, 2, generator=gen, requires_grad=True)
    ga, gb = tpm.gather_parts([a, b], mesh, "model")
    assert torch.equal(tpm.whole_row(ga[1]), torch.cat([a[0], a[1]], dim=-1).detach())
    assert torch.equal(tpm.whole_row(gb[0]), torch.cat([b[0], b[1]], dim=-1).detach())
    wa, wb = torch.randn(2, 3, 4, 10, generator=gen), torch.randn(2, 3, 7, 4, generator=gen)
    (sum((tpm.whole_row(ga[r]) * wa[r]).sum() + (tpm.whole_row(gb[r]) * wb[r]).sum()
         for r in range(2))).backward()
    torch.testing.assert_close(a.grad, torch.stack([wa.sum(0)[..., :5], wa.sum(0)[..., 5:]]))
    torch.testing.assert_close(b.grad, torch.stack([wb.sum(0)[..., :2], wb.sum(0)[..., 2:]]))


# --------------------------------------------------------------------------
# (ii) the setups against the one-device path
# --------------------------------------------------------------------------

# (name, arch, reduced(**kw), mesh, moe_ep_axis)
CONFIGS = [(a, a, {}, "data1-model4", "") for a in
           ("llama3.2-1b", "qwen1.5-4b", "qwen3-32b", "chatglm3-6b", "llava-next-34b",
            "whisper-medium", "mixtral-8x7b", "zamba2-2.7b")] + \
          [(f"llama3.2-1b-{k}", "llama3.2-1b", kw, "data2-model2", "") for k, kw in ODD.items()] + \
          [("mixtral-8x7b-h6kv3-ep", "mixtral-8x7b", ODD["h6kv3"], "data2-model2", "data")]
CASES = [(c, s) for c in CONFIGS for s in SHARDINGS if not (c[4] and s == "zero1")]
IDS = [f"{c[0]}-{s}" for c, s in CASES]


def one_device_step(cfg, p0, batch):
    ocfg, pcfg = OptimConfig(**OCFG), ParallelConfig(remat="none")
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    want_g = train_grads(ref.params, batch, cfg, pcfg, _enc_fn(cfg, pcfg))[0]
    ref, m_ref = make_train_step(cfg, pcfg, ocfg)(ref, batch)
    return want_g, ref, m_ref


@pytest.mark.parametrize("conf,sharding", CASES, ids=IDS)
def test_padded_heads_train_setup_equals_the_one_device_step(conf, sharding):
    _, arch, kw, mesh_name, ep = conf
    cfg = config(arch, **kw)
    p0 = params_of(arch, **kw)
    batch = make_batch(cfg, 1)
    want_g, ref, m_ref = one_device_step(cfg, p0, batch)
    setup = train_setup(cfg, mesh_name, sharding, ep)
    state = setup.init_state(clone(p0))
    synced, m = setup.grad_fn(state, batch)
    for g, w in zip(whole(setup, synced), leaves(want_g)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    state, om = setup.update_fn(state, synced)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert float(m["tokens"]) == float(m_ref["tokens"])
    np.testing.assert_allclose(float(om["grad_norm"]), float(m_ref["grad_norm"]), rtol=1e-5)
    for g, w in zip(whole(setup, state.params), leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def one_device_serve(cfg, params, batch, steps):
    pcfg = ParallelConfig(remat="none")
    logits, state = tfm.prefill(params, batch_to_device(batch, "cpu", torch.float32), cfg,
                                pcfg, cache_len(cfg), enc_fn=_enc_fn(cfg, pcfg))
    out, first = [logits], tree_flatten(state)[0]
    first = [t.clone() for t in first if torch.is_tensor(t)]
    for tok in steps:
        logits, state = tfm.decode_step(params, torch.from_numpy(tok).long(), state, cfg, pcfg)
        out.append(logits)
    return out, first


def setup_serve(cfg, mesh_name, sharding, params, batch, steps, ep=""):
    pre, dec = serve_setups(cfg, mesh_name, sharding, steps[0].shape[0], ep)
    placed = pre.init_state(params)
    logits, state = pre.step_fn(placed, batch)
    out, first = [logits], [t.clone() for t in tree_flatten(state)[0] if torch.is_tensor(t)]
    for tok in steps:
        logits, state = dec.step_fn(placed, state, tok)
        out.append(logits)
    return out, first


def check_serve(cfg, p0, mesh_name, sharding, batch_size, ep=""):
    batch, steps = serve_batch(cfg, batch_size)
    want, want_state = one_device_serve(cfg, p0, batch, steps)
    got, got_state = setup_serve(cfg, mesh_name, sharding, clone(p0), batch, steps, ep)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (batch_size, cfg.padded_vocab)
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"step {i}", **MODEL_TOL)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        assert g.dtype == w.dtype and g.shape[:2] == w.shape[:2] and g.shape[3:] == w.shape[3:]
        n = w.shape[2]           # a cache in the layout: its logical slots, then padding
        np.testing.assert_allclose(g[:, :, :n].numpy(), w.numpy(), **STATE_TOL)
        assert not g[:, :, n:].any()


@pytest.mark.parametrize("conf,sharding", CASES, ids=IDS)
def test_padded_heads_serving_setups_equal_the_one_device_path(conf, sharding):
    _, arch, kw, mesh_name, ep = conf
    cfg = config(arch, **kw)
    check_serve(cfg, params_of(arch, **kw), mesh_name, sharding, B, ep)


BATCH1 = [(c, s) for c in CONFIGS if not c[4] and c[1] != "zamba2-2.7b"
          for s in ("replicated", "fsdp")]


@pytest.mark.parametrize("conf,sharding", BATCH1, ids=[f"{c[0]}-{s}" for c, s in BATCH1])
def test_a_batch_no_data_axis_divides_is_served(conf, sharding):
    """B 1 over data 2 x model 2 (data 1 x model 4): every data row computes
    the same prefill, each rank keeps its block of the caches' sequence (the
    layout over every axis), a decode step combines every rank's block."""
    _, arch, kw, mesh_name, _ = conf
    cfg = config(arch, **kw)
    pre, _ = serve_setups(cfg, "data2-model2", sharding, 1)
    axes = ("data", "model")
    if cfg.family != "hybrid":
        assert pre.state_shardings.kv.k == (None, None, axes, None, None)
    check_serve(cfg, params_of(arch, **kw), "data2-model2", sharding, 1)


def test_a_batch_no_data_axis_divides_without_tp():
    """B 3 over data 4 alone: the caches' sequence over data, no TP."""
    cfg = config("mixtral-8x7b")
    mesh = make_mesh((4,), ("data",), device="cpu")
    p0 = params_of("mixtral-8x7b")
    batch, steps = serve_batch(cfg, 3)
    want, _ = one_device_serve(cfg, p0, batch, steps)
    pre, dec = [make_setup(cfg, ShapeConfig(k, k, cache_len(cfg), 3), mesh)
                for k in ("prefill", "decode")]
    placed = pre.init_state(clone(p0))
    logits, state = pre.step_fn(placed, batch)
    got = [logits]
    for tok in steps:
        logits, state = dec.step_fn(placed, state, tok)
        got.append(logits)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"step {i}", **MODEL_TOL)


# --------------------------------------------------------------------------
# (iii) the collectives
# --------------------------------------------------------------------------

def tp_tree_launches(cfg, kind, tp, seq=False):
    sys.path.insert(0, str(os.path.dirname(SRC)))
    from chip_smoke import tp_tree_launches as count
    return count(cfg, kind, True, tp=tp, seq=seq)


def flash_ranks(cfg, tp):
    sys.path.insert(0, str(os.path.dirname(SRC)))
    from chip_smoke import flash_ranks as count
    return count(cfg, tp)


@pytest.mark.parametrize("name", ["llama3.2-1b-h3kv1", "llama3.2-1b-h6kv3", "whisper-medium",
                                  "qwen3-32b", "zamba2-2.7b"])
def test_every_new_sum_goes_through_the_tree_reduce(monkeypatch, name):
    """A replicated step (no data sync but the flat one), a prefill and a
    decode step: the tree reduces against the formula the card asserts,
    every flash call at a rank's padded heads and the KV heads they read."""
    _, arch, kw, mesh_name, _ = next(c for c in CONFIGS if c[0] == name)
    cfg = config(arch, **kw)
    data, tp = MESHES[mesh_name]
    setup = train_setup(cfg, mesh_name, "replicated")
    p0 = params_of(arch, **kw)
    count = Counting(monkeypatch)
    setup.grad_fn(setup.init_state(clone(p0)), make_batch(cfg, 4))
    sync = len(leaves(p0))                 # the flat sync: one tree reduce a leaf
    assert count.reduce == data * tp_tree_launches(cfg, "train", tp) + sync
    hp = -(-cfg.n_heads // tp)
    assert {h for h, _ in count.heads} <= {hp, cfg.n_heads - hp * (flash_ranks(cfg, tp) - 1)}
    enc = cfg.n_enc_layers if cfg.family == "audio" else 0
    attn = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else
            cfg.num_layers * (2 if cfg.family == "audio" else 1) + enc)
    assert count.attn == data * flash_ranks(cfg, tp) * 2 * attn    # forward, recompute
    pre, dec = serve_setups(cfg, mesh_name, "fsdp")
    placed = pre.init_state(clone(p0))
    batch, steps = serve_batch(cfg)
    count.reduce = 0
    _, state = pre.step_fn(placed, batch)
    assert count.reduce == data * tp_tree_launches(cfg, "prefill", tp)
    count.reduce = 0
    dec.step_fn(placed, state, steps[0])
    assert count.reduce == data * tp_tree_launches(cfg, "decode", tp, seq=True)


# --------------------------------------------------------------------------
# (v) bytes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [B, 1])
def test_a_rank_holds_its_block_of_the_caches(batch_size):
    """In the flash-decoding layout a rank holds ceil(length / ranks) slots
    of every KV head: llama3.2-1b's 3 / 1 over data 2 x model 2, the
    sequence over model (B 8, each data rank its 4 rows) or over both axes
    (B 1)."""
    cfg = config("llama3.2-1b", **ODD["h3kv1"])
    pre, _ = serve_setups(cfg, "data2-model2", "fsdp", batch_size)
    batch, _ = serve_batch(cfg, batch_size)
    _, state = pre.step_fn(pre.init_state(params_of("llama3.2-1b", **ODD["h3kv1"])), batch)
    ranks = 2 if batch_size == B else 4            # the ranks the sequence spreads over
    block = -(-cache_len(cfg) // ranks)
    rows = batch_size // 2 if batch_size == B else 1
    # stacked: every rank's block side by side, the batch rows of both data ranks
    assert state.kv.k.shape == (cfg.num_layers, batch_size, ranks * block, cfg.n_kv_heads,
                                cfg.head_dim)
    per_rank = cfg.num_layers * rows * block * cfg.n_kv_heads * cfg.head_dim
    assert state.kv.k.numel() == 4 * per_rank             # 4 ranks, each its block


# --------------------------------------------------------------------------
# (iv) against the JAX setups on 8 host devices
# --------------------------------------------------------------------------

JAX_CONFIGS = {"llama3.2-1b-h3kv1": ("llama3.2-1b", ODD["h3kv1"]),
               "llama3.2-1b-h6kv3": ("llama3.2-1b", ODD["h6kv3"]),
               "mixtral-8x7b-h6kv3": ("mixtral-8x7b", ODD["h6kv3"])}
JAX_BATCHES = (B, 1)
# the JAX setups place the cache by its spec, which needs its length to divide
# the ranks (8 at B 1); the port pads it
JAX_CACHE = 24

JAX_RUN = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as tfm
from repro.models.config import ParallelConfig, ShapeConfig
from repro.models.modules import split
from repro.parallel.steps import (TrainState, make_decode_setup, make_prefill_setup,
                                  make_train_setup)
from repro.train.optim import OptimConfig, init_adam
CONFIGS, BATCHES, OCFG, NEW = {configs!r}, {batches!r}, {ocfg!r}, {new}
inp = dict(np.load(sys.argv[1]))
out = {{}}


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out[prefix + k] = np.asarray(v, np.float32)


mesh = make_mesh((4, 2), ("data", "model"))
for name, (arch, kw) in CONFIGS.items():
    cfg = get_config(arch).reduced(**kw)
    batch = {{k: jnp.asarray(inp[name + "|train|" + k]) for k in ("tokens", "labels")}}
    B, S = batch["tokens"].shape
    params = split(tfm.init(jax.random.PRNGKey(0), cfg))[0]
    pcfg = ParallelConfig(param_sharding="fsdp", remat="none", param_dtype="float32",
                          compute_dtype="float32")
    ocfg = OptimConfig(**OCFG)
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, ocfg)
    with mesh:
        state = jax.jit(lambda p: TrainState(p, init_adam(p, ocfg)),
                        out_shardings=setup.state_shardings)(params)
        state, m = setup.step_fn(state, batch)
    for k in ("loss", "tokens", "grad_norm"):
        out[name + "|" + k] = np.asarray(m[k], np.float32)
    flat(state.params, name + "|p1|")
    cache = int(inp[name + "|cache"])
    for b in BATCHES:
        sb = {{"tokens": jnp.asarray(inp[f"{{name}}|serve{{b}}|tokens"])}}
        pcfg = ParallelConfig(param_dtype="float32", compute_dtype="float32")
        pre = make_prefill_setup(cfg, ShapeConfig("p", "prefill", cache, b), mesh, pcfg)
        dec = make_decode_setup(cfg, ShapeConfig("d", "decode", cache, b), mesh, pcfg)
        with mesh:
            p = jax.jit(lambda x: x, out_shardings=pre.param_shardings)(params)
            logits, state = pre.step_fn(p, sb)
            out[f"{{name}}|serve{{b}}|0"] = np.asarray(logits, np.float32)
            for i in range(NEW):
                tok = jnp.asarray(inp[f"{{name}}|serve{{b}}|step{{i}}"])
                logits, state = dec.step_fn(p, state, tok)
                out[f"{{name}}|serve{{b}}|{{i + 1}}"] = np.asarray(logits, np.float32)
np.savez(sys.argv[2], **out)
print("JAX_HEADS_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_heads(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_heads")
    inp = {}
    for name, (arch, kw) in JAX_CONFIGS.items():
        cfg = config(arch, **kw)
        for k, v in make_batch(cfg, 7).items():
            inp[f"{name}|train|{k}"] = v
        for b in JAX_BATCHES:
            batch, steps = serve_batch(cfg, b)
            inp[f"{name}|serve{b}|tokens"] = batch["tokens"]
            for i, tok in enumerate(steps):
                inp[f"{name}|serve{b}|step{i}"] = tok
        inp[f"{name}|cache"] = np.array(JAX_CACHE)
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN.format(configs=JAX_CONFIGS, batches=JAX_BATCHES,
                                              ocfg=OCFG, new=NEW),
         str(d / "inputs.npz"), str(d / "jax.npz")],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, f"JAX subprocess failed:\n{proc.stderr[-3000:]}"
    return inp, dict(np.load(d / "jax.npz"))


@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_padded_heads_train_setup_equals_the_jax_setup_on_8_host_devices(jax_heads, name):
    """One fsdp step of the port's (4, 2) setup against the JAX one: the
    metrics and every parameter after it, gathered whole."""
    inp, out = jax_heads
    arch, kw = JAX_CONFIGS[name]
    cfg = config(arch, **kw)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh,
                             ParallelConfig(param_sharding="fsdp", remat="none"),
                             OptimConfig(**OCFG))
    state, m = setup.step_fn(setup.init_state(params_of(arch, **kw)),
                             {k: inp[f"{name}|train|{k}"] for k in ("tokens", "labels")})
    for k in ("loss", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(out[f"{name}|{k}"]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    pre = f"{name}|p1|"
    want = from_jax_params(nest({k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}),
                           cfg, device="cpu")
    for g, w in zip(whole(setup, state.params), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("batch_size", JAX_BATCHES)
@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_padded_heads_serving_setups_equal_the_jax_setups_on_8_host_devices(
        jax_heads, name, batch_size):
    """A prefill and 3 decode steps of the port's (4, 2) fsdp setups against
    the JAX ones: at B 8 the caches' sequence over model, at B 1 over both
    axes."""
    inp, out = jax_heads
    arch, kw = JAX_CONFIGS[name]
    cfg = config(arch, **kw)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    pre, dec = [make_setup(cfg, ShapeConfig(k, k, JAX_CACHE, batch_size), mesh)
                for k in ("prefill", "decode")]
    placed = pre.init_state(params_of(arch, **kw))
    logits, state = pre.step_fn(placed, {"tokens": inp[f"{name}|serve{batch_size}|tokens"]})
    got = [logits]
    for i in range(NEW):
        logits, state = dec.step_fn(placed, state, inp[f"{name}|serve{batch_size}|step{i}"])
        got.append(logits)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), out[f"{name}|serve{batch_size}|{i}"],
                                   err_msg=f"step {i}", **MODEL_TOL)
