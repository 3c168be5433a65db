"""FSDP in the train setup (``parallel.steps.make_train_setup`` with
``param_sharding="fsdp"``, the ``ParallelConfig`` default) and int8 moments
under zero1 and fsdp, on the CPU at reduced size.

References:

(i)   the port's one-device ``make_train_step`` on the whole batch, for the
      llama (fp32 and bf16), mixtral (fp32, its capacity factor E / k, so
      that no choice drops), mamba2, zamba2 (``shared_attn`` outside the
      blocks), llava (``mm_proj``, the patch prefix) and whisper (the
      encoder's blocks) families, over a ``StackedMesh`` of data 4 (flat
      sync), pod 2 x data 2 (hierarchical; the ``embed`` dim over both axes)
      and pod 2 x data 2 x model 1 (hierarchical; ``embed`` over data alone,
      so the shards are summed over pod too, and the embedding over the
      model axis of one rank, whole): loss, every synced gradient shard put
      together, ``grad_norm`` and the parameters after one and two steps, at
      the tolerances of ``tests/test_torch_setup.py``'s docstring.  The FSDP
      setups run under block remat (each block's gather inside the
      recomputed region).
(ii)  the replicated and zero1 setups of the same mesh and sync mode, bit for
      bit: FSDP's synced gradient rows are the shards of the replicated
      setup's synced gradient (each rank's gradient is the same, and the
      tree-reduce sums each element over the same ranks in the same order),
      and its parameters, master and moments after the update are zero1's
      (the clip factor's norm: ``parallel.steps._grad_norm``).  With int8
      moments, the zero1 and fsdp moments (q and the row scales) equal the
      replicated setup's bit for bit.
(iii) one spawned world of 4 ``gloo`` ranks (a ``file://`` store, one
      timeout for the world): the ``DistMesh`` gives the ``StackedMesh``'s
      results bit for bit (synced gradient, metrics, parameters after two
      steps, int8 moments, and a prefill + 2 decode steps of the serving
      setups over fsdp), and a rank holds a quarter of every parameter.

Besides: no tensor of an FSDP step sits in a reference cycle; a leaf whose
sharded dimension does not divide is refused with a ``ValueError`` that names
it; every dimension the specs shard divides over data 8 for all 10 archs, at
full size and reduced.
"""

import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import StackedMesh, make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten, tree_unflatten
from repro_torch.parallel.collectives import build_shard_sync, build_sync
from repro_torch.parallel.sharding import all_blocks, shard_leaf, unshard_leaf
from repro_torch.parallel.steps import (TrainState, _enc_fn, make_setup, make_train_setup,
                                        make_train_step, train_grads)
from repro_torch.train.optim import OptimConfig, QTensor, init_adam

from tests.test_torch_setup import (OCFG, SRC, clone, config, flat, fro, jax_params,
                                    leaves, make_batch, params_of)

B, S = 8, 32
MESHES = {"data4-flat": ((4,), ("data",), "flat"),
          "pod2-data2-hier": ((2, 2), ("pod", "data"), "hierarchical"),
          "pod2-data2-model1-hier": ((2, 2, 1), ("pod", "data", "model"), "hierarchical")}
FAMILIES = [("llama3.2-1b", "float32"), ("llama3.2-1b", "bfloat16"),
            ("mixtral-8x7b", "float32"), ("mamba2-1.3b", "float32"),
            ("zamba2-2.7b", "float32"), ("llava-next-34b", "float32"),
            ("whisper-medium", "float32")]
IS_SPEC = dict(is_leaf=lambda x: isinstance(x, tuple))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: beside the other
    test workers on the same cores, a pool of threads per op spends its time
    waiting (the results do not depend on it; the gloo ranks run one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_of(cfg, seed, masked_shard=False):
    """``make_batch``'s tokens and labels, and the family's patch embeddings
    (vlm) or frames (audio), 0.02 N(0, 1)."""
    batch = make_batch(cfg, seed, masked_shard)
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                                 * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                           * 0.02).astype(np.float32)
    return batch


def setup_of(cfg, mesh_name, sharding, ocfg=None, remat="none"):
    shape, axes, sync = MESHES[mesh_name]
    pcfg = ParallelConfig(param_sharding=sharding, grad_sync=sync, remat=remat)
    return make_train_setup(cfg, ShapeConfig("t", "train", S, B),
                            make_mesh(shape, axes, device="cpu"), pcfg,
                            ocfg or OptimConfig(**OCFG))


def specs_of(setup):
    return tree_flatten(setup.param_shardings, **IS_SPEC)[0]


def whole(setup, tree):
    """A tree in the rows form of the setup's specs, put together."""
    rows, struct = tree_flatten(tree)
    return tree_unflatten(struct, [unshard_leaf(r, s, setup.mesh)
                                   for r, s in zip(rows, specs_of(setup))])


# --------------------------------------------------------------------------
# (i) against the one-device step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,dtype", FAMILIES)
def test_fsdp_equals_the_one_device_step(arch, dtype, mesh_name):
    cfg = config(arch)
    ocfg = OptimConfig(**OCFG)
    pcfg = ParallelConfig(remat="none")
    p0 = params_of(arch, dtype)
    batches = [batch_of(cfg, 1), batch_of(cfg, 2, masked_shard=True)]
    ref = TrainState(clone(p0), init_adam(clone(p0), ocfg))
    step = make_train_step(cfg, pcfg, ocfg)
    want_g, want_m, want_p = [], [], []
    for batch in batches:
        want_g.append(train_grads(ref.params, batch, cfg, pcfg, _enc_fn(cfg, pcfg))[0])
        ref, m = step(ref, batch)
        want_m.append(m)
        want_p.append(clone(ref.params))

    setup = setup_of(cfg, mesh_name, "fsdp", remat="block")
    state = setup.init_state(clone(p0))
    f32 = dtype == "float32"
    for i, batch in enumerate(batches):
        synced, m = setup.grad_fn(state, batch)
        state, om = setup.update_fn(state, synced)
        for k in ("loss", "aux_loss", "tokens"):
            np.testing.assert_allclose(float(m[k]), float(want_m[i][k]), atol=1e-7,
                                       rtol=1e-5 if f32 else 2e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(om["grad_norm"]), float(want_m[i]["grad_norm"]),
                                   rtol=1e-5 if f32 else 2e-2)
        for g, w in zip(leaves(whole(setup, synced)), leaves(want_g[i])):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert fro(g, w) <= (1e-5 if f32 else 2e-2), (i, tuple(g.shape), fro(g, w))
        lr = float(want_m[0]["lr"])
        for g, w in zip(leaves(whole(setup, state.params)), leaves(want_p[i])):
            if f32:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
            else:
                np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                           rtol=2e-2, atol=2 * lr)


# --------------------------------------------------------------------------
# (ii) against the replicated and zero1 setups, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,dtype", [("llama3.2-1b", "float32"), ("llama3.2-1b", "bfloat16"),
                                        ("mixtral-8x7b", "float32"), ("zamba2-2.7b", "float32"),
                                        ("whisper-medium", "float32")])
def test_fsdp_is_bit_equal_to_replicated_and_zero1(arch, dtype, mesh_name):
    cfg = config(arch)
    p0 = params_of(arch, dtype)
    batch = batch_of(cfg, 3)
    f = setup_of(cfg, mesh_name, "fsdp")
    r = setup_of(cfg, mesh_name, "replicated")
    z = setup_of(cfg, mesh_name, "zero1")
    fs, rs, zs = f.init_state(clone(p0)), r.init_state(clone(p0)), z.init_state(clone(p0))
    fg, fm = f.grad_fn(fs, batch)
    rg, rm = r.grad_fn(rs, batch)
    assert torch.equal(fm["loss"], rm["loss"])
    specs = specs_of(f)
    for got, full, spec in zip(leaves(fg), leaves(rg), specs):
        assert torch.equal(got, shard_leaf(full, spec, f.mesh)), spec
    fs, fo = f.update_fn(fs, fg)
    zs, zo = z.update_fn(zs, rg)
    assert torch.equal(fo["grad_norm"], zo["grad_norm"])
    for a, b in zip(leaves(whole(f, fs.params)), leaves(zs.params)):
        assert torch.equal(a, b)
    opt_specs = tree_flatten(z.state_shardings.opt.master, **IS_SPEC)[0]
    for field in ("master", "m", "v"):
        for a, b, sf, sz in zip(leaves(getattr(fs.opt, field)), leaves(getattr(zs.opt, field)),
                                specs, opt_specs):
            assert torch.equal(unshard_leaf(a, sf, f.mesh), unshard_leaf(b, sz, z.mesh)), field


def moments(opt):
    return [(m, v) for m, v in zip(tree_flatten(opt.m, is_leaf=lambda x: isinstance(x, QTensor))[0],
                                   tree_flatten(opt.v, is_leaf=lambda x: isinstance(x, QTensor))[0])]


def expected_scale_rows(full: QTensor, spec, mesh):
    """The scales a rank of the rows form over ``spec`` holds: each row's
    whole scale, beside each of the row's pieces."""
    per_elem = (full.scale[..., None] if full.q.dim() > 1 else full.scale).expand(full.q.shape)
    return all_blocks(per_elem.contiguous(), spec, mesh)[..., 0]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("sharding", ["zero1", "fsdp"])
def test_int8_moments_equal_the_replicated_ones(sharding, mesh_name):
    """Two steps with int8 moments (and no master, so that the parameters
    carry the moments' roundings): q and scale of every moment, and the
    parameters, equal the replicated setup's bit for bit.  ``wo`` (..,
    embed), ``w_down`` and the norms have their rows split over the ranks."""
    cfg = config("llama3.2-1b")
    ocfg = OptimConfig(**OCFG, master=False, moments_dtype="int8")
    p0 = params_of("llama3.2-1b", "float32")
    s = setup_of(cfg, mesh_name, sharding, ocfg)
    r = setup_of(cfg, mesh_name, "replicated", ocfg)
    ss, rs = s.init_state(clone(p0)), r.init_state(clone(p0))
    split = 0
    for seed in (4, 5):
        batch = batch_of(cfg, seed)
        rg, _ = r.grad_fn(rs, batch)
        g = s.grad_fn(ss, batch)[0] if sharding == "fsdp" else rg
        ss, _ = s.update_fn(ss, g)
        rs, _ = r.update_fn(rs, rg)
    specs = [s.ruleset.opt_spec(a)
             for a in tree_flatten(tfm.param_axes(cfg, stacked=False), **IS_SPEC)[0]]
    for (m, v), (wm, wv), spec, p in zip(moments(ss.opt), moments(rs.opt), specs,
                                         leaves(p0)):
        for got, want in ((m, wm), (v, wv)):
            assert torch.equal(unshard_leaf(got.q, spec, s.mesh), want.q), spec
            assert torch.equal(got.scale, expected_scale_rows(want, spec, s.mesh)), spec
        split += len(spec) == p.dim() and spec[-1] is not None
    assert split > 0                           # some rows were split over the ranks
    params = whole(s, ss.params) if sharding == "fsdp" else ss.params
    for a, b in zip(leaves(params), leaves(rs.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the sync on its own, placement, memory
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["flat", "hierarchical"])
def test_shard_sync_gives_the_shards_of_build_sync(mode, mesh_name):
    """``build_shard_sync`` of random replica gradients (bf16) equals the
    shards of ``build_sync``'s mean bit for bit, for specs over every subset
    of the data axes, on any dimension."""
    shape, axes, _ = MESHES[mesh_name]
    mesh = make_mesh(shape, axes, device="cpu")
    sync_axes = ("pod", "data") if "pod" in axes else ("data",)
    outer = "pod" if "pod" in axes else None
    full_sync = build_sync(mesh, mode, inner_axis="data", outer_axis=outer)
    shard_sync = build_shard_sync(mesh, mode, inner_axis="data", outer_axis=outer)
    gen = torch.Generator().manual_seed(0)
    R = mesh.size(sync_axes)
    specs = [(None, None), ("data", None), (None, "data"), ((sync_axes), None),
             (None, sync_axes), ("model" if "model" in axes else None, "data")]
    if outer:
        specs += [("pod", "data"), ("data", "pod"), (("data", "pod"), None)]
    for spec in specs:
        g = torch.randn((R, 8, 12), generator=gen).to(torch.bfloat16)
        want = shard_leaf(full_sync({"x": g})["x"], spec, mesh)
        got = shard_sync(torch.stack([all_blocks(t, spec, mesh) for t in g]), spec)
        assert torch.equal(got, want), spec


def test_a_rank_holds_a_quarter_of_the_parameters():
    """fsdp over data 4: every llama leaf has an ``embed`` or ``vocab`` dim
    over the four ranks, so a rank's block of each leaf is a quarter of it
    (parameters, master, moments)."""
    cfg = config("llama3.2-1b")
    p0 = params_of("llama3.2-1b", "bfloat16")
    setup = setup_of(cfg, "data4-flat", "fsdp")
    state = setup.init_state(clone(p0))
    total = sum(t.numel() * t.element_size() for t in leaves(p0))
    for rows, full in zip(leaves(state.params), leaves(p0)):
        assert rows.shape[0] == 4 and rows[0].numel() * 4 == full.numel()
    rank = sum(r[0].numel() * r.element_size() for r in leaves(state.params))
    assert rank * 4 == total
    for field in ("master", "m", "v"):
        for rows, full in zip(leaves(getattr(state.opt, field)), leaves(p0)):
            assert rows.shape[0] == 4 and rows[0].numel() * 4 == full.numel()


def test_an_fsdp_step_leaves_no_tensor_in_a_reference_cycle():
    """As ``tests/test_torch_setup.py`` pins it for replicated and zero1:
    once an fsdp step's state and metrics are dropped, no tensor of it waits
    for the garbage collector (the gather hooks and the tree walks are
    module functions or closures that do not call themselves)."""
    cfg = config("llama3.2-1b")
    batch = batch_of(cfg, 7)
    p0 = params_of("llama3.2-1b", "float32")
    gc.collect()
    setup = setup_of(cfg, "pod2-data2-model1-hier", "fsdp", remat="block")
    state, m = setup.step_fn(setup.init_state(clone(p0)), batch)
    del state, m, setup
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        held = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert not held


def test_a_leaf_that_does_not_divide_is_refused_by_name():
    """The JAX package pads a ragged tail; the port's setups refuse it, with
    a ``ValueError`` naming the leaf (d_model 64 over data 3)."""
    cfg = config("llama3.2-1b")
    mesh = make_mesh((3,), ("data",), device="cpu")
    for sharding in ("fsdp", "zero1"):
        with pytest.raises(ValueError, match=r"parameter blocks/0/\w+.*does not divide"):
            make_train_setup(cfg, ShapeConfig("t", "train", S, 6), mesh,
                             ParallelConfig(param_sharding=sharding))
    with pytest.raises(ValueError, match=r"parameter blocks/0/\w+.*does not divide"):
        make_setup(cfg, ShapeConfig("p", "prefill", S, 6), mesh, ParallelConfig())
    # replicated places nothing by the spec: it builds
    make_train_setup(cfg, ShapeConfig("t", "train", S, 6), mesh,
                     ParallelConfig(param_sharding="replicated"))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_sharded_dim_divides_over_data_8(arch, reduced):
    """The train and serving setups of every arch build over data 8, pod 2 x
    data 4 and pod 2 x data 4 x model 1 under fsdp (the vocab padded to 256,
    d_model, d_ff and the SSM dims divide), on the meta device."""
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    for shape, axes in (((8,), ("data",)), ((2, 4), ("pod", "data")),
                        ((2, 4, 1), ("pod", "data", "model"))):
        mesh = StackedMesh(shape, axes, "meta")
        seq = 64 + (cfg.n_patches if cfg.family == "vlm" else 0)
        for kind in ("train", "prefill", "decode"):
            setup = make_setup(cfg, ShapeConfig("c", kind, seq, 8), mesh, ParallelConfig())
            assert setup.pcfg.param_sharding == "fsdp"


# --------------------------------------------------------------------------
# (iii) the distributed transport
# --------------------------------------------------------------------------

# (arch, dtype, mesh, moments dtype); then the serving setups over fsdp
GLOO_CASES = [("llama3.2-1b", "float32", "data4-flat", "float32"),
              ("llama3.2-1b", "bfloat16", "pod2-data2-hier", "float32"),
              ("mixtral-8x7b", "float32", "pod2-data2-model1-hier", "float32"),
              ("zamba2-2.7b", "float32", "pod2-data2-hier", "float32"),
              ("whisper-medium", "float32", "data4-flat", "float32"),
              ("llama3.2-1b", "float32", "pod2-data2-model1-hier", "int8")]
SERVE_ARCHS = ("llama3.2-1b", "mamba2-1.3b")

GLOO_WORKER = """
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.sharding import unshard_leaf
from repro_torch.parallel.steps import make_setup, make_train_setup
from repro_torch.train.optim import OptimConfig, QTensor
MESHES, GLOO_CASES, SERVE_ARCHS, OCFG, B, S = (
    {meshes!r}, {cases!r}, {serve!r}, {ocfg!r}, {B}, {S})
rank, store, inputs, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
inp = dict(np.load(inputs))
out = {{}}
is_spec = dict(is_leaf=lambda x: isinstance(x, tuple))


def nest(items):
    tree = {{}}
    for path, v in items.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {{}})
        node[last] = v
    return tree


def config(arch):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def params(arch, dtype):
    return from_jax_params(nest({{k[len(arch) + 3:]: v for k, v in inp.items()
                                  if k.startswith(arch + "|p|")}}), config(arch),
                           device="cpu", dtype=getattr(torch, dtype))


def batch(arch, i):
    return {{k[len(arch) + 4:]: v for k, v in inp.items() if k.startswith(f"{{arch}}|b{{i}}|")}}


def whole(tree, specs, mesh):
    return [unshard_leaf(r, s, mesh).float().numpy()
            for r, s in zip(tree_flatten(tree)[0], specs)]


for n, (arch, dtype, mesh_name, moments) in enumerate(GLOO_CASES):
    cfg = config(arch)
    shape, axes, sync = MESHES[mesh_name]
    mesh = make_dist_mesh(shape, axes, device="cpu")
    pcfg = ParallelConfig(param_sharding="fsdp", grad_sync=sync, remat="block")
    ocfg = OptimConfig(**OCFG, **(dict(master=False, moments_dtype="int8")
                                  if moments == "int8" else {{}}))
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, ocfg)
    specs = tree_flatten(setup.param_shardings, **is_spec)[0]
    state = setup.init_state(params(arch, dtype))
    out[f"{{n}}|bytes"] = np.array(sum(t.numel() * t.element_size()
                                       for t in tree_flatten(state.params)[0]))
    synced, m = setup.grad_fn(state, batch(arch, 0))
    for i, g in enumerate(whole(synced, specs, mesh)):
        out[f"{{n}}|g|{{i}}"] = g
    state, om = setup.update_fn(state, synced)
    m2 = {{**m, **om}}
    state, m3 = setup.step_fn(state, batch(arch, 1))
    for s, mm in enumerate((m2, m3)):
        for k, v in mm.items():
            out[f"{{n}}|m{{s}}|{{k}}"] = v.float().numpy()
    for i, p in enumerate(whole(state.params, specs, mesh)):
        out[f"{{n}}|p|{{i}}"] = p
    if moments == "int8":
        qs = tree_flatten(state.opt.m, is_leaf=lambda x: isinstance(x, QTensor))[0]
        for i, (q, s) in enumerate(zip(qs, specs)):
            out[f"{{n}}|q|{{i}}"] = unshard_leaf(q.q, s, mesh).numpy()
            out[f"{{n}}|scale|{{i}}"] = q.scale.numpy()

for arch in SERVE_ARCHS:
    cfg = config(arch)
    mesh = make_dist_mesh((4,), ("data",), device="cpu")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", S + 4, B), mesh, ParallelConfig())
    dec = make_setup(cfg, ShapeConfig("d", "decode", S + 4, B), mesh, ParallelConfig())
    p = pre.init_state(params(arch, "float32"))
    b = batch(arch, 0)
    logits, state = pre.step_fn(p, {{"tokens": b["tokens"]}})
    out[f"{{arch}}|serve|0"] = logits.numpy()
    for t in range(2):
        logits, state = dec.step_fn(p, state, b["tokens"][:, t:t + 1])
        out[f"{{arch}}|serve|{{t + 1}}"] = logits.numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_fsdp")
    inp = {}
    for arch in {a for a, _, _, _ in GLOO_CASES} | set(SERVE_ARCHS):
        for k, v in flat(jax_params(arch)).items():
            inp[arch + "|p|" + k] = v
        for i, batch in enumerate((batch_of(config(arch), 5),
                                   batch_of(config(arch), 6, masked_shard=True))):
            for k, v in batch.items():
                inp[f"{arch}|b{i}|{k}"] = v
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    worker = GLOO_WORKER.format(meshes=MESHES, cases=GLOO_CASES, serve=SERVE_ARCHS,
                                ocfg=OCFG, B=B, S=S)
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(rank), str(d / "gloo_store"),
         str(d / "inputs.npz"), str(d / f"rank_{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(4)]
    try:
        logs = [p.communicate(timeout=300) for p in procs]   # one limit for the world
    finally:
        for p in procs:
            p.kill()
    bad = [(i, err[-2000:]) for i, (p, (_, err)) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"gloo ranks failed: {bad}"
    return inp, [dict(np.load(d / f"rank_{rank}.npz")) for rank in range(4)]


def _batch(inp, arch, i):
    pre = f"{arch}|b{i}|"
    return {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}


@pytest.mark.parametrize("n", range(len(GLOO_CASES)),
                         ids=["-".join(c) for c in GLOO_CASES])
def test_gloo_fsdp_equals_the_stacked_mesh(gloo_world, n):
    inp, ranks = gloo_world
    arch, dtype, mesh_name, moments = GLOO_CASES[n]
    cfg = config(arch)
    ocfg = OptimConfig(**OCFG, **(dict(master=False, moments_dtype="int8")
                                  if moments == "int8" else {}))
    setup = setup_of(cfg, mesh_name, "fsdp", ocfg, remat="block")
    p0 = params_of(arch, dtype)
    state = setup.init_state(clone(p0))
    synced, m = setup.grad_fn(state, _batch(inp, arch, 0))
    grads = leaves(whole(setup, synced))
    state, om = setup.update_fn(state, synced)
    metrics = [{**m, **om}]
    state, m3 = setup.step_fn(state, _batch(inp, arch, 1))
    metrics.append(m3)
    params = leaves(whole(setup, state.params))
    rank_bytes = sum(r[0].numel() * r.element_size() for r in leaves(state.params))
    for rank, res in enumerate(ranks):
        for i, g in enumerate(grads):
            assert np.array_equal(res[f"{n}|g|{i}"], g.float().numpy()), (rank, i)
        for s, mm in enumerate(metrics):
            for k, v in mm.items():
                assert np.array_equal(res[f"{n}|m{s}|{k}"], v.float().numpy()), (rank, s, k)
        for i, p in enumerate(params):
            assert np.array_equal(res[f"{n}|p|{i}"], p.float().numpy()), (rank, i)
        # a rank holds its block of every leaf: one row of the stacked form
        assert int(res[f"{n}|bytes"]) == rank_bytes, rank
    if moments == "int8":
        specs = specs_of(setup)
        qs = tree_flatten(state.opt.m, is_leaf=lambda x: isinstance(x, QTensor))[0]
        mesh = setup.mesh
        for rank, res in enumerate(ranks):
            coords = np.unravel_index(rank, tuple(mesh.shape.values()))
            coords = dict(zip(mesh.axis_names, coords))
            for i, (q, spec) in enumerate(zip(qs, specs)):
                assert np.array_equal(res[f"{n}|q|{i}"], unshard_leaf(q.q, spec, mesh).numpy())
                names = [a for e in spec for a in
                         (() if e is None else (e,) if isinstance(e, str) else e)]
                row = 0
                for a in names:
                    row = row * mesh.shape[a] + int(coords[a])
                assert np.array_equal(res[f"{n}|scale|{i}"], q.scale[row:row + 1].numpy())


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_gloo_serving_setups_equal_the_stacked_mesh(gloo_world, arch):
    """A prefill and two decode steps over fsdp on data 4: each ``gloo`` rank
    prefills and steps its two rows; the all-gathered logits equal the
    stacked mesh's bit for bit."""
    inp, ranks = gloo_world
    cfg = config(arch)
    mesh = make_mesh((4,), ("data",), device="cpu")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", S + 4, B), mesh, ParallelConfig())
    dec = make_setup(cfg, ShapeConfig("d", "decode", S + 4, B), mesh, ParallelConfig())
    p = pre.init_state(params_of(arch, "float32"))
    b = _batch(inp, arch, 0)
    logits, state = pre.step_fn(p, {"tokens": b["tokens"]})
    want = [logits]
    for t in range(2):
        logits, state = dec.step_fn(p, state, b["tokens"][:, t:t + 1])
        want.append(logits)
    for rank, res in enumerate(ranks):
        for t, w in enumerate(want):
            assert np.array_equal(res[f"{arch}|serve|{t}"], w.numpy()), (rank, t)

