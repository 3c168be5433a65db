"""Elastic resume and fault injection (``repro_torch.train.elastic``,
``repro_torch.train.faults``) on the CPU at reduced size, against the JAX
package's ``train.elastic`` / ``train.faults``.

References:

(i)   the JAX functions themselves, in this process, on every case of
      ``tests/test_multidevice.py``: ``validate_shape_for_mesh``, ``_best_dp``,
      ``plan_shrink`` (with its memory gate on seeded cases, one it
      rejects), ``shrink_mesh``'s de-duplication and order, and its mesh
      under the memory gate against the JAX ``plan_shrink`` that the JAX
      ``shrink_mesh`` builds its mesh from;
(ii)  one module-scoped JAX subprocess on 8 host devices (as
      ``tests/test_torch_setup.py`` builds it), fp32 from the same weights
      (converted) and batches: ``resume_on_mesh`` (4, 2) → (2, 2) after one
      step and a checkpoint, and ``crash_and_recover`` on (2, 4) with
      ``n_failed=5`` (the model axis re-planned to 2); held: the plan, the
      failed positions, the resumed step, the swept debris, the loss after
      the resumed step (rtol 1e-5) and every parameter (atol 1e-5); and the
      positions of ``seeded_device_failure`` on both meshes;
(iii) one spawned world of 4 ``gloo`` ranks (a ``file://`` store, one
      timeout for the world): ``Trainer(mesh=DistMesh)`` over data 2 x model
      2 under fsdp takes 2 steps; its checkpoint is written once, by rank 0,
      and is bit-equal to the ``StackedMesh``'s; a stop flag set on rank 1
      alone stops every rank after the same step; ``shrink_mesh`` refuses
      the ``DistMesh``.  Then a world of 2 ranks resumes that checkpoint
      through ``resume_on_mesh`` (zero1 over model 2) and takes a step, bit
      for bit the stacked mesh's resume.
"""

import dataclasses
import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.config import SHAPES_BY_NAME as J_SHAPES
from repro.train import elastic as jelastic

from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import SHAPES_BY_NAME, ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.steps import make_train_setup
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic, faults
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
B, S = 8, 32
OCFG = dict(warmup_steps=0, eps=1e-6)
ARCH = "llama3.2-1b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (as
    ``tests/test_torch_setup.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree):
    return tree_flatten(tree)[0]


def make_batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, get_config(ARCH).reduced().vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[rng.random((B, S)) < np.arange(B)[:, None] / 9] = -1
    return {"tokens": toks[:, :-1].copy(), "labels": labels}


def nest(flat_items):
    tree = {}
    for path, v in flat_items.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


# --------------------------------------------------------------------------
# (i) the planning functions against JAX's
# --------------------------------------------------------------------------

def plan_both(n_alive, tp, batch, cfg=None, gate=None, **replace):
    """(port's, JAX's) plan_shrink, each a result or the error's message;
    ``gate`` is (shape name, npu_hbm_bytes) for the memory gate."""
    out = []
    for fn, get, shapes in ((elastic.plan_shrink, get_config, SHAPES_BY_NAME),
                            (jelastic.plan_shrink, jax_get_config, J_SHAPES)):
        model_cfg = None
        if cfg:
            model_cfg = dataclasses.replace(get(cfg), **replace) if replace else get(cfg)
        kw = dict(shape=shapes[gate[0]], npu_hbm_bytes=gate[1]) if gate else {}
        try:
            out.append(fn(n_alive, tp, batch, model_cfg=model_cfg, **kw))
        except ValueError as e:
            out.append(str(e))
    return out


def gate_cases(seed, n):
    """Seeded plans that reach the memory gate: the model axis eaten into, a
    registry model, a shape, and a budget of 1-128 GiB a device."""
    rng = random.Random(seed)
    archs = ("llama3.2-1b", "qwen3-32b", "mixtral-8x7b", "mamba2-1.3b", "chatglm3-6b")
    out = {}
    for i in range(n):
        tp = rng.choice((4, 8, 16))
        out[f"gate-seeded-{i}"] = (
            rng.randint(1, tp - 1), tp, rng.choice((8, 32, 256)), rng.choice(archs), {},
            (rng.choice(("train_4k", "decode_32k")), 2 ** rng.uniform(30, 37)))
    return out


PLAN_CASES = {
    "dp-flexes": (6, 2, 32, None, {}, None),
    "tp-eaten-llama": (3, 4, 4096, "llama3.2-1b", {}, None),
    "tp-eaten-odd-heads": (5, 8, 32, "llama3.2-1b", dict(n_heads=6, n_kv_heads=6, d_ff=36),
                           None),
    "tp-eaten-ssm": (3, 4, 32, "mamba2-1.3b", {}, None),
    "tp-eaten-down-to-one": (3, 4, 32, "llama3.2-1b", dict(n_heads=3, n_kv_heads=3), None),
    "tp-zero": (4, 0, 32, None, {}, None),
    "no-survivor": (0, 2, 32, None, {}, None),
    "no-model-cfg": (1, 2, 32, None, {}, None),
    "batch-limits-dp": (7, 1, 12, None, {}, None),
    "gate-passes": (3, 4, 256, "llama3.2-1b", {}, ("train_4k", 64 * 2 ** 30)),
    "gate-rejects-every-divisor": (3, 4, 256, "qwen3-32b", {}, ("train_4k", 2 ** 30)),
    "gate-and-divisibility-reject": (5, 8, 32, "llama3.2-1b",
                                     dict(n_heads=6, n_kv_heads=6, d_ff=36),
                                     ("train_4k", 2 ** 20)),
    "gate-not-reached-while-tp-fits": (6, 2, 32, "qwen3-32b", {}, ("train_4k", 2 ** 30)),
    **gate_cases(0, 8),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_shrink_equals_jax(case):
    n_alive, tp, batch, cfg, replace, gate = PLAN_CASES[case]
    got, want = plan_both(n_alive, tp, batch, cfg, gate, **replace)
    assert got == want


def test_plan_shrink_memory_gate_waits_for_m12():
    """The name is historical: the gate waited for the cost model (ROADMAP.md
    M12), which the port now has (``repro_torch.core``).  ``plan_shrink`` and
    ``shrink_mesh`` with ``shape`` and ``npu_hbm_bytes`` equal the JAX ones.
    The JAX ``shrink_mesh`` builds its ``(data, model)`` mesh from its
    ``plan_shrink`` on the survivors, so the port's mesh is held to that plan,
    and a plan the gate rejects to the JAX message."""
    cfg, jcfg = get_config("qwen3-32b"), jax_get_config("qwen3-32b")
    shape = SHAPES_BY_NAME["train_4k"]
    mesh = make_mesh((2, 8), ("data", "model"), device="meta")
    rejected = 0
    for failed, hbm in (([3, 5, 9, 10, 11, 12, 13, 14, 15], 128 * 2 ** 30),
                        (list(range(1, 12)), 16 * 2 ** 30),
                        (list(range(1, 12)), 256 * 2 ** 30),
                        ([4], 2 ** 30)):
        got, want = plan_both(16 - len(failed), 8, shape.global_batch, "qwen3-32b",
                              ("train_4k", hbm))
        assert got == want
        try:
            want = jelastic.plan_shrink(16 - len(failed), 8, shape.global_batch,
                                        model_cfg=jcfg, shape=J_SHAPES["train_4k"],
                                        npu_hbm_bytes=hbm)
        except ValueError as e:
            assert "exceeds per-NPU memory" in str(e)
            with pytest.raises(ValueError) as err:
                elastic.shrink_mesh(mesh, failed, shape, cfg=cfg, npu_hbm_bytes=hbm)
            assert str(err.value) == str(e)
            rejected += 1
            continue
        got = elastic.shrink_mesh(mesh, failed, shape, cfg=cfg, npu_hbm_bytes=hbm)
        assert (got.shape["data"], got.shape["model"]) == want, failed
        alive = [r for r in range(16) if r not in failed]
        assert got.ranks == tuple(alive[:want[0] * want[1]])
    assert rejected == 1


def test_best_dp_and_validate_shape_equal_jax():
    for n_alive in range(1, 17):
        for tp in (1, 2, 4):
            for batch in (1, 6, 8, 12, 32):
                if n_alive >= tp:
                    assert elastic._best_dp(n_alive, tp, batch) == \
                        jelastic._best_dp(n_alive, tp, batch)
    for shape_, axes in (((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
                         ((8,), ("data",)), ((1, 4), ("data", "model"))):
        mesh = make_mesh(shape_, axes, device="meta")   # JAX's reads mesh.shape alone
        for batch in (2, 4, 6, 8):
            got, want = [], []
            for fn, out in ((elastic.validate_shape_for_mesh, got),
                            (jelastic.validate_shape_for_mesh, want)):
                try:
                    fn(ShapeConfig("t", "train", S, batch), mesh)
                    out.append("ok")
                except ValueError as e:
                    out.append(str(e))
            assert got == want, (shape_, batch)


def test_shrink_mesh_dedupes_and_keeps_order():
    """As ``tests/test_multidevice.py::test_shrink_mesh_dedupes_duplicate_failure_reports``:
    each dead rank reported twice is one failure, and the survivors keep the
    mesh's order; a shrunk mesh shrinks again with its ranks' record."""
    cfg = get_config(ARCH).reduced()
    shape = ShapeConfig("t", "train", S, B)
    mesh8 = make_mesh((4, 2), ("data", "model"), device="cpu")
    mesh = elastic.shrink_mesh(mesh8, [6, 6, 7, 7], shape, cfg=cfg)
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    assert mesh.ranks == (0, 1, 2, 3) and mesh.device == mesh8.device
    mesh = elastic.shrink_mesh(mesh8, [1], shape, cfg=cfg)       # 7 alive: dp 3 → 2
    assert dict(mesh.shape) == {"data": 2, "model": 2} and mesh.ranks == (0, 2, 3, 4)
    again = elastic.shrink_mesh(mesh, [0, 3], shape, cfg=cfg)
    assert dict(again.shape) == {"data": 1, "model": 2} and again.ranks == (2, 3)
    with pytest.raises(ValueError, match="not positions"):
        elastic.shrink_mesh(mesh8, [8], shape)


def test_torn_save_debris_is_ignored_and_swept(tmp_path):
    cfg = get_config(ARCH).reduced()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh,
                             ParallelConfig(remat="none", param_dtype="float32"),
                             OptimConfig(**OCFG))
    from repro_torch.models import transformer as tfm
    state = setup.init_state(tfm.init(0, cfg, device="cpu"))
    ckpt.save(tmp_path, state, step=1, extras={"step": 1}, to_logical=setup.leaf_to_logical)
    with pytest.raises(faults.TornWrite, match="after 2/"):
        faults.torn_save(tmp_path, state, step=2, fail_after_leaves=2,
                         to_logical=setup.leaf_to_logical)
    debris = tmp_path / "step_00000002.tmp"
    assert sorted(p.name for p in debris.iterdir()) == ["leaf_00000.npy", "leaf_00001.npy"]
    # the torn leaves are the logical ones, as the committed step's files
    assert np.array_equal(np.load(debris / "leaf_00001.npy"),
                          np.load(tmp_path / "step_00000001" / "leaf_00001.npy"))
    assert ckpt.latest_step(tmp_path) == 1
    assert ckpt.cleanup_incomplete(tmp_path) == 1 and not debris.exists()
    assert ckpt.latest_step(tmp_path) == 1


def test_flaky_io_is_absorbed_by_retry_io(monkeypatch):
    monkeypatch.setattr(ckpt.time, "sleep", lambda _s: None)
    failures = 2
    fn = faults.FlakyIO(lambda: "ok", failures=failures)
    assert ckpt._retry_io(fn, "probe") == "ok"
    assert fn.calls == failures + 1
    stuck = faults.FlakyIO(lambda: "never", failures=100)
    with pytest.raises(OSError, match="injected transient IO failure"):
        ckpt._retry_io(stuck, "probe")
    assert stuck.calls == ckpt.IO_RETRIES


# --------------------------------------------------------------------------
# (ii) against the JAX elastic resume and fault recovery on 8 host devices
# --------------------------------------------------------------------------

JAX_RUN = """
import pathlib, sys, tempfile
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as tfm
from repro.models.config import ParallelConfig, ShapeConfig
from repro.models.modules import split
from repro.parallel.steps import TrainState, make_train_setup
from repro.train import checkpoint as ckpt, faults
from repro.train.elastic import resume_on_mesh
from repro.train.optim import OptimConfig, init_adam
inp = dict(np.load(sys.argv[1]))
out = {{}}


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out[prefix + k] = np.asarray(v, np.float32)


cfg = get_config({arch!r}).reduced()
shape = ShapeConfig("t", "train", {S}, {B})
pcfg = ParallelConfig(remat="none", param_dtype="float32", compute_dtype="float32")
ocfg = OptimConfig(**{ocfg!r})
b1, b2 = ({{k: jnp.asarray(inp[b + "|" + k]) for k in ("tokens", "labels")}}
          for b in ("b1", "b2"))
params = split(tfm.init(jax.random.PRNGKey(0), cfg))[0]
flat(params, "p0|")
for name, mshape in (("resume", (4, 2)), ("crash", (2, 4))):
    mesh = make_mesh(mshape, ("data", "model"))
    setup = make_train_setup(cfg, shape, mesh, pcfg, ocfg)
    with mesh:
        # placed by a jitted init, as tests/test_multidevice.py places it
        state = jax.jit(lambda p: TrainState(p, init_adam(p, ocfg)),
                        out_shardings=setup.state_shardings)(params)
        state, _ = setup.step_fn(state, b1)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, state, step=1, extras={{"step": 1}})
        if name == "resume":
            new_mesh = make_mesh((2, 2), ("data", "model"))
            new, st, at = resume_on_mesh(d, cfg, shape, new_mesh, pcfg, ocfg)
        else:
            rec = faults.crash_and_recover(d, cfg, shape, mesh, state, torn_step=2,
                                           n_failed=5, seed=0, pcfg=pcfg, ocfg=ocfg)
            new, st, at, new_mesh = rec.setup, rec.state, rec.resumed_step, rec.mesh
            devs = list(mesh.devices.flat)
            out[name + "|failed"] = np.array([devs.index(x) for x in rec.failed])
            out[name + "|plan"] = np.array([rec.plan["data"], rec.plan["model"]])
            out[name + "|swept"] = np.array(not (pathlib.Path(d) / "step_00000002.tmp").exists())
        out[name + "|at"] = np.array(at)
        with new_mesh:
            st, m = new.step_fn(st, b2)
        out[name + "|loss"] = np.asarray(m["loss"], np.float32)
        flat(st.params, name + "|p|")
for mshape in ((4, 2), (2, 4)):
    mesh = make_mesh(mshape, ("data", "model"))
    devs = list(mesh.devices.flat)
    for seed in range(3):
        for n in (1, 3, 5, 7):
            out["draw|%d%d|%d|%d" % (*mshape, seed, n)] = np.array(
                [devs.index(x) for x in faults.seeded_device_failure(mesh, n, seed)])
np.savez(sys.argv[2], **out)
print("JAX_ELASTIC_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_elastic")
    inp = {}
    for name, seed in (("b1", 1), ("b2", 2)):
        for k, v in make_batch(seed).items():
            inp[name + "|" + k] = v
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN.format(arch=ARCH, S=S, B=B, ocfg=OCFG),
         str(d / "inputs.npz"), str(d / "jax.npz")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"JAX subprocess failed:\n{proc.stderr[-3000:]}"
    out = dict(np.load(d / "jax.npz"))
    params = from_jax_params(nest({k[3:]: v for k, v in out.items() if k.startswith("p0|")}),
                             get_config(ARCH).reduced(), device="cpu")
    return inp, out, params


def port_run(params, batches, mshape, tmp_path):
    """The port's first half of a scenario: one step on ``mshape`` (data,
    model) from ``params``, a checkpoint of step 1.  Returns (mesh, state)."""
    cfg = get_config(ARCH).reduced()
    mesh = make_mesh(mshape, ("data", "model"), device="cpu")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, PCFG,
                             OptimConfig(**OCFG))
    state, _ = setup.step_fn(setup.init_state(params), batches["b1"])
    ckpt.save(tmp_path, state, step=1, extras={"step": 1}, to_logical=setup.leaf_to_logical)
    return mesh, state


PCFG = ParallelConfig(remat="none", param_dtype="float32", compute_dtype="float32")


def held_against_jax(out, name, setup, state, batch):
    """The resumed step against JAX's: loss rtol 1e-5, parameters atol 1e-5."""
    state, m = setup.step_fn(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(out[name + "|loss"]), rtol=1e-5)
    pre = name + "|p|"
    want = from_jax_params(nest({k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}),
                           get_config(ARCH).reduced(), device="cpu")
    got = setup.state_to_logical(state).params
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def batches_of(inp):
    return {b: {k: inp[b + "|" + k] for k in ("tokens", "labels")} for b in ("b1", "b2")}


def test_resume_on_another_mesh_equals_jax(jax_elastic, tmp_path):
    """(4, 2) → (2, 2), as ``tests/test_multidevice.py::test_elastic_restart_8_to_4_devices``."""
    inp, out, params = jax_elastic
    batches = batches_of(inp)
    port_run(params, batches, (4, 2), tmp_path)
    setup, state, at = elastic.resume_on_mesh(
        str(tmp_path), get_config(ARCH).reduced(), ShapeConfig("t", "train", S, B),
        make_mesh((2, 2), ("data", "model"), device="cpu"), PCFG, OptimConfig(**OCFG))
    assert at == int(out["resume|at"]) == 1
    assert dict(setup.mesh.shape) == {"data": 2, "model": 2}
    held_against_jax(out, "resume", setup, state, batches["b2"])


def test_crash_and_recover_equals_jax(jax_elastic, tmp_path):
    """(2, 4), a torn save of step 2 and 5 of 8 ranks dead, as
    ``tests/test_multidevice.py::test_fault_injection_tp_eating_failure_replans_model_axis``."""
    inp, out, params = jax_elastic
    batches = batches_of(inp)
    cfg = get_config(ARCH).reduced()
    mesh, state = port_run(params, batches, (2, 4), tmp_path)
    rec = faults.crash_and_recover(tmp_path, cfg, ShapeConfig("t", "train", S, B), mesh, state,
                                   torn_step=2, n_failed=5, seed=0, pcfg=PCFG,
                                   ocfg=OptimConfig(**OCFG))
    assert rec.plan == {"data": int(out["crash|plan"][0]), "model": int(out["crash|plan"][1])}
    assert rec.plan == {"data": 1, "model": 2}
    assert list(rec.failed) == out["crash|failed"].tolist()
    assert rec.mesh.ranks == tuple(r for r in range(8) if r not in rec.failed)[:2]
    assert rec.resumed_step == int(out["crash|at"]) == 1
    assert bool(out["crash|swept"]) and not (tmp_path / "step_00000002.tmp").exists()
    held_against_jax(out, "crash", rec.setup, rec.state, batches["b2"])


@pytest.mark.parametrize("mshape", [(4, 2), (2, 4)])
def test_seeded_device_failure_equals_jax(jax_elastic, mshape):
    _, out, _ = jax_elastic
    mesh = make_mesh(mshape, ("data", "model"), device="meta")
    for seed in range(3):
        for n in (1, 3, 5, 7):
            want = out["draw|%d%d|%d|%d" % (*mshape, seed, n)].tolist()
            assert faults.seeded_device_failure(mesh, n, seed) == want
    with pytest.raises(ValueError, match="n_failed"):
        faults.seeded_device_failure(mesh, 8)


# --------------------------------------------------------------------------
# (iii) the distributed transport
# --------------------------------------------------------------------------

GLOO_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.train import checkpoint as ckpt, elastic
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig
rank, world, store, d, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                   sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
cfg = get_config({arch!r}).reduced()
shape = ShapeConfig("t", "train", {S}, {B})
ocfg = OptimConfig(**{ocfg!r})
out = {{}}


def pcfg(sharding):
    return ParallelConfig(param_sharding=sharding, grad_sync="flat", remat="none",
                          param_dtype="float32", compute_dtype="float32")


if world == 4:
    mesh = make_dist_mesh((2, 2), ("data", "model"), device="cpu")
    real_save, written = ckpt.np.save, []

    def counting_save(*a, **kw):
        written.append(1)
        return real_save(*a, **kw)
    ckpt.np.save = counting_save
    tr = Trainer(cfg, shape, pcfg("fsdp"), ocfg,
                 TrainerConfig(steps=2, log_every=1, checkpoint_every=2,
                               checkpoint_dir=d + "/run"), mesh=mesh)
    tr.run()
    ckpt.np.save = real_save
    out["written"] = np.array(len(written))
    out["latest"] = np.array(ckpt.latest_step(d + "/run"))
    out["history"] = np.array([h["loss"] for h in tr.history], np.float64)
    # a stop flag set on rank 1 alone, after its first step
    tr = Trainer(cfg, shape, pcfg("fsdp"), ocfg,
                 TrainerConfig(steps=10, log_every=1, checkpoint_every=100,
                               checkpoint_dir=d + "/stop"), mesh=mesh)
    step_fn = tr.step_fn

    def stop_on_rank_1(state, batch):
        res = step_fn(state, batch)
        if rank == 1:
            tr._stop = True
        return res
    tr.step_fn = stop_on_rank_1
    tr.run()
    out["stop_step"] = np.array(tr.step)
    out["stop_latest"] = np.array(ckpt.latest_step(d + "/stop"))
    try:
        elastic.shrink_mesh(mesh, [3], shape, cfg=cfg)
        out["shrink"] = np.array("ran")
    except ValueError as e:
        out["shrink"] = np.array(str(e))
else:
    mesh = make_dist_mesh((1, 2), ("data", "model"), device="cpu")
    setup, state, at = elastic.resume_on_mesh(d + "/run", cfg, shape, mesh, pcfg("zero1"), ocfg)
    inp = dict(np.load(d + "/batch.npz"))
    state, m = setup.step_fn(state, inp)
    out["at"] = np.array(at)
    out["loss"] = m["loss"].numpy()
    for i, t in enumerate(tree_flatten(setup.state_to_logical(state))[0]):
        out["leaf|%d" % i] = t.numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
"""


def spawn_world(d, world, tag):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    worker = GLOO_WORKER.format(arch=ARCH, S=S, B=B, ocfg=OCFG)
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(rank), str(world), str(d / f"store_{tag}"), str(d),
         str(d / f"{tag}_{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]   # one limit for the world
    finally:
        for p in procs:
            p.kill()
    bad = [(i, err[-2000:]) for i, (p, (_, err)) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"gloo ranks failed: {bad}"
    return [dict(np.load(d / f"{tag}_{rank}.npz")) for rank in range(world)]


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_elastic")
    np.savez(d / "batch.npz", **make_batch(3))
    four = spawn_world(d, 4, "train")
    two = spawn_world(d, 2, "resume")
    return d, four, two


def stacked_trainer(tmp):
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tr = Trainer(get_config(ARCH).reduced(), ShapeConfig("t", "train", S, B),
                 ParallelConfig(param_sharding="fsdp", grad_sync="flat", remat="none",
                                param_dtype="float32", compute_dtype="float32"),
                 OptimConfig(**OCFG),
                 TrainerConfig(steps=2, log_every=1, checkpoint_every=2, checkpoint_dir=str(tmp)),
                 mesh=mesh)
    tr.run()
    return tr


def test_gloo_trainer_writes_its_checkpoint_once_as_the_stacked_mesh(gloo_worlds, tmp_path):
    d, four, _ = gloo_worlds
    tr = stacked_trainer(tmp_path)
    got, want = d / "run" / "step_00000002", tmp_path / "step_00000002"
    files = sorted(p.name for p in want.glob("leaf_*.npy"))
    # one save of step 2 (the periodic one; the final one is not written again), by rank 0
    assert [int(r["written"]) for r in four] == [len(files), 0, 0, 0]
    assert all(int(r["latest"]) == 2 for r in four)
    assert (got / "MANIFEST.json").read_text() == (want / "MANIFEST.json").read_text()
    for f in files:
        assert np.array_equal(np.load(got / f), np.load(want / f)), f
    # history on the writing rank only, the stacked mesh's losses to the bit
    assert four[0]["history"].tolist() == [h["loss"] for h in tr.history]
    assert all(r["history"].size == 0 for r in four[1:])


def test_gloo_stop_on_one_rank_stops_every_rank(gloo_worlds):
    _, four, _ = gloo_worlds
    assert [int(r["stop_step"]) for r in four] == [1, 1, 1, 1]
    assert all(int(r["stop_latest"]) == 1 for r in four)


def test_gloo_shrink_mesh_refuses_a_dist_mesh(gloo_worlds):
    _, four, _ = gloo_worlds
    assert all("DistMesh" in str(r["shrink"]) for r in four)


def test_gloo_two_ranks_resume_as_the_stacked_mesh(gloo_worlds, tmp_path):
    d, _, two = gloo_worlds
    stacked_trainer(tmp_path)
    setup, state, at = elastic.resume_on_mesh(
        str(tmp_path), get_config(ARCH).reduced(), ShapeConfig("t", "train", S, B),
        make_mesh((1, 2), ("data", "model"), device="cpu"),
        ParallelConfig(param_sharding="zero1", grad_sync="flat", remat="none",
                       param_dtype="float32", compute_dtype="float32"), OptimConfig(**OCFG))
    state, m = setup.step_fn(state, dict(np.load(d / "batch.npz")))
    want = leaves(setup.state_to_logical(state))
    for res in two:
        assert int(res["at"]) == at == 2
        assert np.array_equal(res["loss"], m["loss"].numpy())
        for i, w in enumerate(want):
            assert np.array_equal(res["leaf|%d" % i], w.numpy()), i
