"""The serving setups (``parallel.steps.make_prefill_setup`` /
``make_decode_setup`` / ``make_setup``) on the CPU, at reduced size.

References:

(i)   the port's one-device ``prefill`` + 4 ``decode_step``s on the whole
      batch (B 8), for the dense (llama), MoE (mixtral, capacity E / k),
      SSM (mamba2), hybrid (zamba2), vlm (llava with ``patch_embeds``) and
      audio (whisper with ``frames``) families, with the parameters
      replicated, zero1 (whole, as replicated) and fsdp (each block gathered
      when it runs) over a ``StackedMesh`` of data 4, and fsdp over pod 2 x
      data 2 x model 1: the logits of every step and the decode state after
      the prefill, fp32, atol 1e-5 + rtol 1e-4 (each rank runs its rows of
      the batch, so the products sum over other row blocks; measured
      < 5e-7).
(ii)  the JAX ``make_prefill_setup`` / ``make_decode_setup`` on 8 host
      devices, a (4, 2) ``data`` / ``model`` mesh with the ``ParallelConfig``
      default (fsdp), in one module-scoped subprocess (the parameters placed
      by a jitted identity with ``out_shardings``): the logits of the prefill
      and of 4 decode steps from the converted weights, against the port's
      fsdp setups over data 4, at ``tests/test_torch_models.py``'s
      ``MODEL_TOL`` (atol 1e-4 / rtol 1e-3); and llama, llava and whisper's
      against the port's own (4, 2) setups, tensor parallelism over
      ``model`` 2.
(iii) the ``CellSetup`` fields against the same subprocess's setups on a
      data 8 mesh: the input and decode-state shapes and dtypes
      (``example_args`` / ``state_shapes``, on the meta device here), the
      parameter count, and ``state_shardings`` spec for spec.

And each refusal: a batch that no data axis divides, an SSM configuration
under a ``model`` axis of more than one rank (a MoE one and ``moe_ep_axis``,
once refused, now build).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import StackedMesh, make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.steps import (_enc_fn, batch_to_device, make_decode_setup,
                                        make_prefill_setup, make_setup)

from tests.test_torch_setup import SRC, clone, config, jax_params, params_of

ARCHS = ["llama3.2-1b", "mixtral-8x7b", "mamba2-1.3b", "zamba2-2.7b", "llava-next-34b",
         "whisper-medium"]
B, S, NEW = 8, 12, 4
MESHES = {"data4": ((4,), ("data",)),
          "pod2-data2-model1": ((2, 2, 1), ("pod", "data", "model"))}
TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: beside the other
    test workers on the same cores, a pool of threads per op spends its time
    waiting (the results do not depend on it; the gloo ranks run one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cache_len(cfg):
    return S + (cfg.n_patches if cfg.family == "vlm" else 0) + NEW


def serve_batch(cfg, seed=11):
    """Prompt tokens (B, S), the family's patch embeddings or frames (0.02
    N(0, 1)), and the tokens fed to the decode steps (B, 1) each."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                                 * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                           * 0.02).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32) for _ in range(NEW)]
    return batch, steps


def one_device(cfg, params, batch, steps):
    pcfg = ParallelConfig(remat="none")
    logits, state = tfm.prefill(params, batch_to_device(batch, "cpu", torch.float32), cfg,
                                pcfg, cache_len(cfg), enc_fn=_enc_fn(cfg, pcfg))
    out, first = [logits], [t.clone() for t in tree_flatten(state)[0] if torch.is_tensor(t)]
    for tok in steps:
        logits, state = tfm.decode_step(params, torch.from_numpy(tok).long(), state, cfg, pcfg)
        out.append(logits)
    return out, first


def through_setups(cfg, params, batch, steps, mesh, sharding):
    pcfg = ParallelConfig(param_sharding=sharding)
    pre = make_setup(cfg, ShapeConfig("p", "prefill", cache_len(cfg), B), mesh, pcfg)
    dec = make_setup(cfg, ShapeConfig("d", "decode", cache_len(cfg), B), mesh, pcfg)
    placed = pre.init_state(params)
    logits, state = pre.step_fn(placed, batch)
    out, first = [logits], [t.clone() for t in tree_flatten(state)[0] if torch.is_tensor(t)]
    for tok in steps:
        logits, state = dec.step_fn(placed, state, tok)
        out.append(logits)
    return out, first


# --------------------------------------------------------------------------
# (i) against the one-device path
# --------------------------------------------------------------------------

CASES = [(a, s, "data4") for a in ARCHS for s in ("replicated", "zero1", "fsdp")] + \
        [(a, "fsdp", "pod2-data2-model1") for a in ARCHS]


@pytest.mark.parametrize("arch,sharding,mesh_name", CASES)
def test_serving_setups_equal_the_one_device_path(arch, sharding, mesh_name):
    cfg = config(arch)
    p0 = params_of(arch, "float32")
    batch, steps = serve_batch(cfg)
    want, want_state = one_device(cfg, p0, batch, steps)
    mesh = make_mesh(*MESHES[mesh_name], device="cpu")
    got, got_state = through_setups(cfg, clone(p0), batch, steps, mesh, sharding)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"step {i}", **TOL)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_the_decode_state_is_written_in_place():
    """The decode setup writes each rank's rows into the state it was given
    (as ``decode_step`` does): the returned state holds the same buffers."""
    cfg = config("llama3.2-1b")
    batch, steps = serve_batch(cfg)
    mesh = make_mesh((4,), ("data",), device="cpu")
    pre = make_prefill_setup(cfg, ShapeConfig("p", "prefill", cache_len(cfg), B), mesh)
    dec = make_decode_setup(cfg, ShapeConfig("d", "decode", cache_len(cfg), B), mesh)
    p = pre.init_state(params_of("llama3.2-1b", "float32"))
    _, state = pre.step_fn(p, batch)
    before = state.kv.k[:, :, S].clone()
    _, new = dec.step_fn(p, state, steps[0])
    assert new.kv.k is state.kv.k and new.index == state.index + 1
    assert not torch.equal(state.kv.k[:, :, S], before)      # every row's new slot


# --------------------------------------------------------------------------
# (ii), (iii) against the JAX setups on 8 host devices
# --------------------------------------------------------------------------

JAX_RUN = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as tfm
from repro.models.config import ParallelConfig, ShapeConfig
from repro.models.modules import split
from repro.parallel.steps import make_decode_setup, make_prefill_setup
ARCHS, NEW = {archs!r}, {new}
inp = dict(np.load(sys.argv[1]))
out, fields = {{}}, {{}}


def spec_list(tree):
    return [list(map(lambda e: list(e) if isinstance(e, tuple) else e, s.spec))
            for s in jax.tree.leaves(tree)]


def shape_list(tree):
    return [[list(x.shape), str(x.dtype)] for x in jax.tree.leaves(tree)]


for arch in ARCHS:
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    batch = {{k[len(arch) + 1:]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith(arch + "|") and "|step" not in k}}
    B = batch["tokens"].shape[0]
    cache = int(inp[arch + "|cache"])
    batch.pop("cache")
    pcfg = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    mesh = make_mesh((4, 2), ("data", "model"))
    pre = make_prefill_setup(cfg, ShapeConfig("p", "prefill", cache, B), mesh, pcfg)
    dec = make_decode_setup(cfg, ShapeConfig("d", "decode", cache, B), mesh, pcfg)
    params = split(tfm.init(jax.random.PRNGKey(0), cfg))[0]
    with mesh:
        params = jax.jit(lambda p: p, out_shardings=pre.param_shardings)(params)
        logits, state = pre.step_fn(params, batch)
        out[arch + "|0"] = np.asarray(logits, np.float32)
        for i in range(NEW):
            logits, state = dec.step_fn(params, state, jnp.asarray(inp[f"{{arch}}|step{{i}}"]))
            out[f"{{arch}}|{{i + 1}}"] = np.asarray(logits, np.float32)
    # the fields on a data 8 mesh, the ParallelConfig defaults
    mesh8 = make_mesh((8,), ("data",))
    pre = make_prefill_setup(cfg, ShapeConfig("p", "prefill", cache, B), mesh8)
    dec = make_decode_setup(cfg, ShapeConfig("d", "decode", cache, B), mesh8)
    fields[arch] = {{
        "inputs": shape_list(pre.example_args[1]),
        "params": int(sum(np.prod(x.shape) for x in jax.tree.leaves(pre.param_shapes))),
        "state_shapes": shape_list(dec.state_shapes.__class__(*dec.state_shapes[:4], None)),
        "tokens": shape_list(dec.example_args[2]),
        "prefill_state_specs": spec_list(pre.state_shardings),
        "decode_state_specs": spec_list(dec.state_shardings)}}
np.savez(sys.argv[2], **out)
json.dump(fields, open(sys.argv[3], "w"))
print("JAX_SERVE_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("jax_serve")
    inp = {}
    for arch in ARCHS:
        cfg = config(arch)
        batch, steps = serve_batch(cfg)
        for k, v in batch.items():
            inp[f"{arch}|{k}"] = v
        for i, tok in enumerate(steps):
            inp[f"{arch}|step{i}"] = tok
        inp[f"{arch}|cache"] = np.array(cache_len(cfg))
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN.format(archs=ARCHS, new=NEW),
         str(d / "inputs.npz"), str(d / "jax.npz"), str(d / "fields.json")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"JAX subprocess failed:\n{proc.stderr[-3000:]}"
    return dict(np.load(d / "jax.npz")), json.load(open(d / "fields.json"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_setups_equal_the_jax_setups_on_8_host_devices(jax_serve, arch):
    out, _ = jax_serve
    cfg = config(arch)
    batch, steps = serve_batch(cfg)
    params = from_jax_params(jax_params(arch), cfg, device="cpu")
    mesh = make_mesh((4,), ("data",), device="cpu")
    got, _ = through_setups(cfg, params, batch, steps, mesh, "fsdp")
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), out[f"{arch}|{i}"], err_msg=f"step {i}",
                                   **MODEL_TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llava-next-34b", "whisper-medium"])
def test_tp_serving_setups_equal_the_jax_setups_on_8_host_devices(jax_serve, arch):
    """The port's own (4, 2) ``data`` / ``model`` setups (fsdp, tensor
    parallelism over ``model`` 2: each rank its heads, its vocab block, its
    KV heads of the cache) against the JAX setups on the same mesh."""
    out, _ = jax_serve
    cfg = config(arch)
    batch, steps = serve_batch(cfg)
    params = from_jax_params(jax_params(arch), cfg, device="cpu")
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    got, _ = through_setups(cfg, params, batch, steps, mesh, "fsdp")
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), out[f"{arch}|{i}"], err_msg=f"step {i}",
                                   **MODEL_TOL)


def _shape_list(tree):
    return [[list(t.shape), str(t.dtype).replace("torch.", "")]
            for t in tree_flatten(tree)[0] if torch.is_tensor(t)]


def _spec_list(tree):
    is_spec = dict(is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields"))
    return [[list(e) if isinstance(e, tuple) else e for e in s]
            for s in tree_flatten(tree, **is_spec)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_setup_fields_equal_the_jax_ones(jax_serve, arch):
    _, fields = jax_serve
    want = fields[arch]
    cfg = config(arch)
    mesh = StackedMesh((8,), ("data",), "meta")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", cache_len(cfg), B), mesh)
    dec = make_setup(cfg, ShapeConfig("d", "decode", cache_len(cfg), B), mesh)
    assert pre.pcfg.remat == dec.pcfg.remat == "none"
    params, inputs = pre.example_args
    assert all(t.device.type == "meta" for t in tree_flatten(params)[0])
    assert _shape_list(inputs) == want["inputs"]
    assert sum(t.numel() for t in tree_flatten(params)[0]) == want["params"]
    assert _shape_list(dec.state_shapes) == want["state_shapes"]
    assert dec.example_args[1] is dec.state_shapes
    assert _shape_list(dec.example_args[2]) == want["tokens"]
    assert _spec_list(pre.state_shardings) == want["prefill_state_specs"]
    assert _spec_list(dec.state_shardings) == want["decode_state_specs"]


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("make", [make_prefill_setup, make_decode_setup],
                         ids=["prefill", "decode"])
def test_the_serving_setups_refuse_what_waits(make):
    """Its lines are historical: a ``model`` axis of 2 was refused for every
    family, then for the MoE and SSM ones, then for the SSM one,
    ``moe_ep_axis`` was refused, and a batch that no data axis divides was
    refused until the flash-decoding layout ran; now every family builds
    under ``model`` 2 (``tests/test_torch_tp.py``,
    ``tests/test_torch_moe_tp.py`` and ``tests/test_torch_ssm_tp.py`` serve
    them over it), the MoE family under ``moe_ep_axis``, and a batch of 3
    over data 4 runs, the caches' sequence over ``data``
    (``tests/test_torch_heads_tp.py`` holds the rest)."""
    cfg = config("llama3.2-1b")
    shape = ShapeConfig("s", "prefill", 32, B)
    data4 = make_mesh((4,), ("data",), device="cpu")
    small = ShapeConfig("s", "prefill", cache_len(cfg), 3)
    setup = make(cfg, small, data4)
    assert setup.state_shardings.kv.k == (None, None, "data", None, None)
    p0 = params_of("llama3.2-1b", "float32")
    batch, steps = serve_batch(cfg)
    batch = {k: v[:3] for k, v in batch.items()}
    want, _ = one_device(cfg, p0, batch, [t[:3] for t in steps[:1]])
    pre = make_prefill_setup(cfg, small, data4)
    placed = pre.init_state(clone(p0))
    got, state = pre.step_fn(placed, batch)
    if make is make_decode_setup:
        got, _ = setup.step_fn(placed, state, steps[0][:3])
    np.testing.assert_allclose(got.numpy(), want[make is make_decode_setup].numpy(), **TOL)
    # tensor parallelism runs for every family
    model2 = make_mesh((4, 2), ("data", "model"), device="cpu")
    assert make(config("mixtral-8x7b"), shape, model2).ruleset.expert_sharded
    setup = make(config("mamba2-1.3b"), shape, model2)
    assert setup.state_shardings.ssm.h == (None, "data", "model", None, None)
    setup = make(config("mixtral-8x7b"), shape, data4, ParallelConfig(moe_ep_axis="data"))
    assert setup.ruleset.ep_axis == "data"
