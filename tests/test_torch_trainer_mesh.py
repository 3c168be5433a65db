"""``Trainer(mesh=)`` over the train setups, and checkpoints of sharded state,
on the CPU at reduced size (fp32 unless said).

References:

(i)   the setup's own state: ``place_state(state_to_logical(s))`` is ``s`` bit
      for bit, before and after a step, and ``state_to_logical(init_state(p))``
      is ``TrainState(p, init_adam(p))``, for replicated, zero1 and fsdp over
      data 4, data 2 x model 2 and pod 2 x data 2, fp32 and int8 moments
      (llama3.2-1b), for mixtral-8x7b with its experts over data
      (``moe_ep_axis``) and mamba2-1.3b over model 2;
(ii)  the one-device ``Trainer`` over 4 steps with a checkpoint at 2, for a
      placement of each family (dense, moe, ssm, hybrid): the history's
      losses (rtol 1e-5), the parameters (atol 1e-5), and the checkpoints'
      manifests (treedef, shapes, dtypes, extras);
(iii) bit for bit between placements whose steps are bit-equal (replicated,
      zero1 and fsdp over data 4): every leaf file of the checkpoint;
(iv)  an uninterrupted fsdp run over data 2 x model 2: its checkpoint of step
      2 resumes on data 4 under zero1, on model 4 and on one device, and the
      next step's loss (rtol 1e-5) and parameters (atol 1e-5) are the
      uninterrupted run's;
(v)   SIGTERM mid-run on a mesh: a final checkpoint of the last step, the
      handlers restored.

Adam eps 1e-6 and no warmup, as ``tests/test_torch_setup.py`` has them (a
flipped update would show as 6e-4 in a parameter).
"""

import dataclasses
import json
import shutil
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig, ShapeConfig
from repro_torch.models.modules import tree_flatten
from repro_torch.parallel.steps import TrainState, make_train_setup
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import OptimConfig, init_adam
from repro_torch.train.train_loop import Trainer, TrainerConfig

B, S = 8, 16
OCFG = dict(warmup_steps=0, eps=1e-6)
MESHES = {"data4": ((4,), ("data",)), "data2-model2": ((2, 2), ("data", "model")),
          "pod2-data2": ((2, 2), ("pod", "data")), "model2": ((1, 2), ("data", "model")),
          "model4": ((1, 4), ("data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (as
    ``tests/test_torch_setup.py``: beside the other test workers a pool of
    threads per op spends its time waiting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:     # every choice fits its expert's bucket: nothing drops
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def pcfg_of(mesh, sharding, ep=""):
    sync = "hierarchical" if "pod" in MESHES[mesh][1] else "flat"
    return ParallelConfig(param_sharding=sharding, grad_sync=sync, remat="none", moe_ep_axis=ep,
                          param_dtype="float32", compute_dtype="float32")


def leaves(tree):
    return tree_flatten(tree)[0]


def assert_bit_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        assert torch.equal(a, b), i


def batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    labels = toks[:, 1:].copy()
    labels[rng.random((B, S)) < np.arange(B)[:, None] / 9] = -1
    return {"tokens": toks[:, :-1].copy(), "labels": labels}


# --------------------------------------------------------------------------
# (i) the logical state and back
# --------------------------------------------------------------------------

LOGICAL_CASES = (
    [("llama3.2-1b", m, s, md, "") for m in ("data4", "data2-model2", "pod2-data2")
     for s in ("replicated", "zero1", "fsdp") for md in ("float32", "int8")]
    + [("mixtral-8x7b", "data2-model2", s, md, "data") for s in ("replicated", "fsdp")
       for md in ("float32", "int8")]
    + [("mamba2-1.3b", "model2", s, md, "") for s in ("replicated", "zero1", "fsdp")
       for md in ("float32", "int8")])


@pytest.mark.parametrize("arch,mesh,sharding,moments,ep", LOGICAL_CASES,
                         ids=["-".join(filter(None, c)) for c in LOGICAL_CASES])
def test_place_state_inverts_state_to_logical(arch, mesh, sharding, moments, ep):
    cfg = config(arch)
    ocfg = OptimConfig(**OCFG, moments_dtype=moments)
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B),
                             make_mesh(*MESHES[mesh], device="cpu"), pcfg_of(mesh, sharding, ep),
                             ocfg)
    params = tfm.init(0, cfg, device="cpu")
    state = setup.init_state(params)
    fresh = TrainState(params, init_adam(params, ocfg))
    assert_bit_equal(setup.state_to_logical(state), fresh)
    assert_bit_equal(setup.place_state(fresh), state)
    # the logical leaves have the shapes the checkpoint's target takes
    for got, want in zip(leaves(setup.state_to_logical(state)), leaves(setup.state_shapes)):
        assert got.shape == want.shape and got.dtype == want.dtype
    state, _ = setup.step_fn(state, batch(cfg, 1))
    assert_bit_equal(setup.place_state(setup.state_to_logical(state)), state)


# --------------------------------------------------------------------------
# (ii) against the one-device Trainer
# --------------------------------------------------------------------------

def run_trainer(tmp, cfg, steps, checkpoint_every, mesh=None, sharding="fsdp", ep="",
                state=None):
    """A Trainer on ``mesh`` (a MESHES name; None: one device) run for
    ``steps`` steps from its directory's latest checkpoint or the seed."""
    m = make_mesh(*MESHES[mesh], device="cpu") if mesh else None
    pcfg = pcfg_of(mesh or "data4", sharding, ep)
    tr = Trainer(cfg, ShapeConfig("t", "train", S, B), pcfg, OptimConfig(**OCFG),
                 TrainerConfig(steps=steps, log_every=1, checkpoint_every=checkpoint_every,
                               checkpoint_dir=str(tmp)),
                 **({"mesh": m} if m else {"device": "cpu"}))
    state = tr.run(state)
    logical = tr.setup.state_to_logical(state) if m else state
    return tr, logical


_ONE_DEVICE = {}


def one_device(arch, tmp_path_factory):
    if arch not in _ONE_DEVICE:
        d = tmp_path_factory.mktemp(f"one_{arch}")
        tr, logical = run_trainer(d, config(arch), 4, 2)
        _ONE_DEVICE[arch] = (d, [h["loss"] for h in tr.history], logical)
    return _ONE_DEVICE[arch]


def manifest(d, step):
    m = json.loads((Path(d) / f"step_{step:08d}" / "MANIFEST.json").read_text())
    for leaf in m["leaves"]:
        leaf.pop("crc32")
    return m


TRAINER_CASES = [("llama3.2-1b", "data4", "replicated", ""),
                 ("llama3.2-1b", "data2-model2", "zero1", ""),
                 ("llama3.2-1b", "pod2-data2", "fsdp", ""),
                 ("mixtral-8x7b", "data2-model2", "fsdp", "data"),
                 ("mamba2-1.3b", "data2-model2", "fsdp", ""),
                 ("zamba2-2.7b", "model2", "replicated", "")]


@pytest.mark.parametrize("arch,mesh,sharding,ep", TRAINER_CASES,
                         ids=["-".join(filter(None, c)) for c in TRAINER_CASES])
def test_trainer_on_a_mesh_equals_the_one_device_trainer(tmp_path, tmp_path_factory, arch, mesh,
                                                         sharding, ep):
    one_dir, one_losses, one_state = one_device(arch, tmp_path_factory)
    tr, logical = run_trainer(tmp_path, config(arch), 4, 2, mesh, sharding, ep)
    assert [h["step"] for h in tr.history] == [1, 2, 3, 4]
    np.testing.assert_allclose([h["loss"] for h in tr.history], one_losses, rtol=1e-5)
    for got, want in zip(leaves(logical.params), leaves(one_state.params)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    # logical leaves in the one-device layout: the manifests agree but for the crcs
    assert ckpt.latest_step(tmp_path) == 4
    for step in (2, 4):
        assert manifest(tmp_path, step) == manifest(one_dir, step)


# --------------------------------------------------------------------------
# (iii) placements whose steps are bit-equal write the same checkpoint
# --------------------------------------------------------------------------

_DATA4 = {}


def data4_checkpoint(sharding, tmp_path_factory):
    if sharding not in _DATA4:
        d = tmp_path_factory.mktemp(f"data4_{sharding}")
        run_trainer(d, config("llama3.2-1b"), 2, 2, "data4", sharding)
        _DATA4[sharding] = d / "step_00000002"
    return _DATA4[sharding]


@pytest.mark.parametrize("sharding", ["zero1", "fsdp"])
def test_checkpoints_of_bit_equal_placements_are_bit_equal(tmp_path_factory, sharding):
    got, want = (data4_checkpoint(s, tmp_path_factory) for s in (sharding, "replicated"))
    assert json.loads((got / "MANIFEST.json").read_text()) == \
        json.loads((want / "MANIFEST.json").read_text())
    files = sorted(p.name for p in want.glob("leaf_*.npy"))
    assert files == sorted(p.name for p in got.glob("leaf_*.npy"))
    for f in files:
        assert np.array_equal(np.load(got / f), np.load(want / f)), f


# --------------------------------------------------------------------------
# (iv) a checkpoint of one placement resumes on another
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """fsdp over data 2 x model 2, 3 steps, a checkpoint at 2."""
    d = tmp_path_factory.mktemp("fsdp_2x2")
    tr, logical = run_trainer(d, config("llama3.2-1b"), 3, 2, "data2-model2", "fsdp")
    return d, tr.history[-1], logical


@pytest.mark.parametrize("target", ["data4-zero1", "model4-fsdp", "one-device"])
def test_an_fsdp_checkpoint_resumes_on_another_placement(tmp_path, uninterrupted, target):
    src, last, want = uninterrupted
    shutil.copytree(src / "step_00000002", tmp_path / "step_00000002")
    mesh, sharding = target.split("-") if target != "one-device" else (None, "fsdp")
    tr, logical = run_trainer(tmp_path, config("llama3.2-1b"), 3, 100, mesh, sharding)
    assert [h["step"] for h in tr.history] == [3]
    np.testing.assert_allclose(tr.history[0]["loss"], last["loss"], rtol=1e-5)
    for got, w in zip(leaves(logical.params), leaves(want.params)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-5)
    assert ckpt.latest_step(tmp_path) == 3


# --------------------------------------------------------------------------
# (v) preemption on a mesh
# --------------------------------------------------------------------------

def test_trainer_on_a_mesh_stops_on_sigterm_with_a_final_checkpoint(tmp_path):
    cfg = config("llama3.2-1b")
    before = signal.getsignal(signal.SIGTERM)
    mesh = make_mesh(*MESHES["data2-model2"], device="cpu")
    tr = Trainer(cfg, ShapeConfig("t", "train", S, B), pcfg_of("data2-model2", "fsdp"),
                 OptimConfig(**OCFG),
                 TrainerConfig(steps=10, log_every=1, checkpoint_every=100,
                               checkpoint_dir=str(tmp_path)), mesh=mesh)
    step_fn = tr.step_fn

    def step_then_preempt(state, b):
        out = step_fn(state, b)
        if tr.step == 1:                  # the second step is the last
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return out
    tr.step_fn = step_then_preempt
    state = tr.run()
    assert tr.step == 2 and ckpt.latest_step(tmp_path) == 2
    assert signal.getsignal(signal.SIGTERM) is before
    tr2 = Trainer(cfg, ShapeConfig("t", "train", S, B), pcfg_of("data2-model2", "fsdp"),
                  OptimConfig(**OCFG), TrainerConfig(checkpoint_dir=str(tmp_path)), mesh=mesh)
    resumed = tr2.resume_or_init()
    assert tr2.step == 2
    assert_bit_equal(resumed, state)


def test_trainer_refuses_a_device_that_is_not_the_mesh_s():
    mesh = make_mesh(*MESHES["data4"], device="cpu")
    with pytest.raises(ValueError, match="not the mesh's device"):
        Trainer(config("llama3.2-1b"), ShapeConfig("t", "train", S, B), mesh=mesh,
                device="meta")
    tr = Trainer(config("llama3.2-1b"), ShapeConfig("t", "train", S, B), mesh=mesh,
                 device="cpu")
    assert tr.device == mesh.device and tr.setup.mesh is mesh
