"""The port's checkpointing (``repro_torch.train.checkpoint``) on the CPU: the
semantics of the JAX package's checkpoint tests (``tests/test_substrate.py``)
on tensor trees, and the layout the two packages share.

Every checkpoint directory is a ``tmp_path``; every writer thread is joined.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt

from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamState, OptimConfig, QTensor, init_adam


class FlakyIO:
    """Wraps ``fn``; its first ``failures`` calls raise OSError (the
    reference's ``train.faults.FlakyIO``)."""

    def __init__(self, fn, failures):
        self.fn, self.failures, self.calls = fn, failures, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.calls <= self.failures:
            raise OSError("transient")
        return self.fn(*a, **kw)


def sample_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": (torch.arange(5.0) / 3).to(torch.bfloat16)},
            "n": torch.arange(6, dtype=torch.int32)}


def zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip_bit_exact_and_atomic(tmp_path):
    tree = sample_tree()
    ckpt.save(tmp_path, tree, step=3, extras={"step": 3})
    assert ckpt.latest_step(tmp_path) == 3
    (tmp_path / "step_00000009").mkdir()          # uncommitted: ignored
    assert ckpt.latest_step(tmp_path) == 3
    target = zeros_like_tree(tree)
    restored, extras = ckpt.restore(tmp_path, target)
    assert_tree_equal(restored, tree)
    assert restored["a"] is target["a"]           # written into the target
    assert extras["step"] == 3


def test_bf16_is_stored_as_raw_words_and_stated_in_the_manifest(tmp_path):
    tree = {"w": torch.tensor([1.0, -2.5, 3e-3, 65504.0]).to(torch.bfloat16)}
    d = ckpt.save(tmp_path, tree, step=1)
    meta = json.loads((d / "MANIFEST.json").read_text())["leaves"][0]
    assert meta["dtype"] == "bfloat16" and meta["stored_as"] == "uint16 words of bfloat16"
    raw = np.load(d / meta["file"])
    assert raw.dtype == np.uint16
    assert np.array_equal(raw, tree["w"].view(torch.int16).numpy().view(np.uint16))


def test_jax_package_reads_a_port_checkpoint(tmp_path):
    """The layout is the JAX package's: its ``restore`` reads a port save of
    the same leaves (a flat tree, bf16 included) bit for bit."""
    import jax.numpy as jnp
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": (torch.arange(4.0) / 7).to(torch.bfloat16)}
    ckpt.save(tmp_path, tree, step=2, extras={"step": 2})
    target = {"a": jnp.zeros((2, 3)), "b": jnp.zeros(4, jnp.bfloat16)}
    restored, extras = jckpt.restore(tmp_path, target)
    np.testing.assert_array_equal(np.asarray(restored["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(restored["b"]).view(np.uint16),
                                  tree["b"].view(torch.int16).numpy().view(np.uint16))
    assert extras["step"] == 2


def test_optimizer_state_with_quantised_moments_roundtrips(tmp_path):
    params = {"w": torch.randn(4, 8, generator=torch.Generator().manual_seed(0)),
              "v": torch.randn(8, generator=torch.Generator().manual_seed(1))}
    state = init_adam(params, OptimConfig(moments_dtype="int8", master=False))
    state = state._replace(step=torch.tensor(7, dtype=torch.int32),
                           m={k: QTensor(q.q + 3, q.scale * 2) for k, q in state.m.items()})
    tree = {"params": params, "opt": state}
    ckpt.save(tmp_path, tree, step=7)
    target = {"params": zeros_like_tree(params),
              "opt": init_adam(params, OptimConfig(moments_dtype="int8", master=False))}
    restored, _ = ckpt.restore(tmp_path, target)
    assert isinstance(restored["opt"], AdamState) and restored["opt"].master is None
    assert int(restored["opt"].step) == 7
    for k in params:
        assert torch.equal(restored["params"][k], params[k])
        assert torch.equal(restored["opt"].m[k].q, state.m[k].q)
        assert torch.equal(restored["opt"].m[k].scale, state.m[k].scale)


def test_restore_refuses_another_architecture(tmp_path):
    ckpt.save(tmp_path, {"a": torch.ones(3)}, step=1)
    with pytest.raises(ValueError, match="architecture mismatch"):
        ckpt.restore(tmp_path, {"a": torch.ones(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="stored"):
        ckpt.restore(tmp_path, {"a": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", {"a": torch.ones(3)})


def test_checkpoint_crc_detects_corruption(tmp_path):
    tree = {"a": torch.arange(100.0)}
    path = ckpt.save(tmp_path, tree, step=1)
    leaf = path / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, {"a": torch.zeros(100)})


def test_async_checkpointer_and_gc(tmp_path):
    tree = {"a": torch.ones(16)}
    ac = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    try:
        for s in (1, 2, 3, 4):
            ac.save(tree, step=s, extras={"step": s})
    finally:
        ac.wait()
    assert ac._thread is None and ac.last_committed == 4
    ac._gc()
    assert ckpt.latest_step(tmp_path) == 4
    steps = sorted(int(p.name[5:]) for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert len(steps) <= 2


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The train step updates tensors in place right after ``save`` returns:
    the checkpoint holds the values at the call."""
    t = torch.zeros(1000)
    ac = ckpt.AsyncCheckpointer(tmp_path, keep=3)
    try:
        ac.save({"t": t}, step=1)
        t.add_(1.0)
    finally:
        ac.wait()
    restored, _ = ckpt.restore(tmp_path, {"t": torch.empty(1000)})
    assert not restored["t"].any()


def test_async_checkpointer_reports_a_failed_write(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt.time, "sleep", lambda _s: None)
    monkeypatch.setattr(ckpt.np, "save", FlakyIO(np.save, failures=100))
    ac = ckpt.AsyncCheckpointer(tmp_path)
    ac.save({"a": torch.ones(2)}, step=1)
    with pytest.raises(OSError):
        ac.wait()
    assert ac._thread is None
    ac.wait()                                     # reported once


def test_retry_io_absorbs_transient_oserrors(monkeypatch):
    sleeps = []
    monkeypatch.setattr(ckpt.time, "sleep", sleeps.append)
    fn = FlakyIO(lambda: "ok", failures=2)
    assert ckpt._retry_io(fn, "probe") == "ok"
    assert fn.calls == 3
    assert sleeps == [ckpt.IO_BACKOFF_S, ckpt.IO_BACKOFF_S * 2]
    stuck = FlakyIO(lambda: "never", failures=100)
    with pytest.raises(OSError):
        ckpt._retry_io(stuck, "probe")
    assert stuck.calls == ckpt.IO_RETRIES


def test_the_ports_flaky_io_behaves_as_the_stand_in():
    """``train.faults.FlakyIO`` fails as this file's stand-in does: the first
    ``failures`` calls raise OSError, every call is counted."""
    from repro_torch.train.faults import FlakyIO as PortFlakyIO
    for failures in (0, 1, 3):
        ours, port = FlakyIO(lambda x: x + 1, failures), PortFlakyIO(lambda x: x + 1, failures)
        for call in range(failures + 2):
            got = []
            for f in (ours, port):
                try:
                    got.append(f(call))
                except OSError:
                    got.append("OSError")
            assert got[0] == got[1], (failures, call)
        assert ours.calls == port.calls == failures + 2


def test_retry_policy_equals_the_reference():
    assert (ckpt.IO_RETRIES, ckpt.IO_BACKOFF_S) == (jckpt.IO_RETRIES, jckpt.IO_BACKOFF_S)


def test_checkpoint_save_and_restore_retry_flaky_io(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt.time, "sleep", lambda _s: None)
    tree = {"a": torch.arange(6.0), "b": torch.ones(3, dtype=torch.bfloat16)}
    flaky_save = FlakyIO(np.save, failures=2)
    monkeypatch.setattr(ckpt.np, "save", flaky_save)
    ckpt.save(tmp_path, tree, step=1, extras={"step": 1})
    monkeypatch.setattr(ckpt.np, "save", np.save)
    assert flaky_save.calls > 2
    assert ckpt.latest_step(tmp_path) == 1
    flaky_load = FlakyIO(np.load, failures=2)
    monkeypatch.setattr(ckpt.np, "load", flaky_load)
    restored, extras = ckpt.restore(tmp_path, zeros_like_tree(tree))
    monkeypatch.setattr(ckpt.np, "load", np.load)
    assert flaky_load.calls > 2
    assert extras["step"] == 1
    assert_tree_equal(restored, tree)


def test_cleanup_incomplete_idempotent_under_race(tmp_path, monkeypatch):
    """Two recoveries sweeping the same dir concurrently: the second rmtree
    of a dir the other recovery already removed is a no-op, not an error."""
    root = tmp_path / "ck"
    ckpt.save(root, {"a": torch.ones(2)}, step=1)
    d1, d2 = root / "step_00000002.tmp", root / "step_00000003.tmp"
    d1.mkdir()
    d2.mkdir()
    real_rmtree = shutil.rmtree
    state = {"first": True}

    def racing_rmtree(path, **kw):
        if state["first"]:
            state["first"] = False
            real_rmtree(d2, ignore_errors=True)
        real_rmtree(path, **kw)

    monkeypatch.setattr(ckpt.shutil, "rmtree", racing_rmtree)
    assert ckpt.cleanup_incomplete(root) == 2
    monkeypatch.setattr(ckpt.shutil, "rmtree", real_rmtree)
    assert not d1.exists() and not d2.exists()
    assert ckpt.latest_step(root) == 1
    assert ckpt.cleanup_incomplete(root) == 0
    real_rmtree(root)
    assert ckpt.cleanup_incomplete(root) == 0      # root gone: still a no-op


def test_torn_save_leaves_sweepable_debris(tmp_path, monkeypatch):
    """A writer that dies after its first leaf leaves ``step_X.tmp`` with no
    manifest and no COMMIT: invisible to ``latest_step``, swept by
    ``cleanup_incomplete``."""
    tree = {"a": torch.arange(4.0), "b": torch.ones(2)}
    ckpt.save(tmp_path, tree, step=1, extras={"step": 1})

    class TornWrite(Exception):
        pass

    calls = {"n": 0}

    def dying_save(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise TornWrite()
        return np.save(*a, **kw)

    monkeypatch.setattr(ckpt.np, "save", dying_save)
    with pytest.raises(TornWrite):
        ckpt.save(tmp_path, tree, step=2)
    monkeypatch.setattr(ckpt.np, "save", np.save)
    debris = Path(tmp_path) / "step_00000002.tmp"
    assert debris.exists()
    assert not (debris / "COMMIT").exists() and not (debris / "MANIFEST.json").exists()
    assert ckpt.latest_step(tmp_path) == 1
    assert ckpt.cleanup_incomplete(tmp_path) == 1
    restored, extras = ckpt.restore(tmp_path, zeros_like_tree(tree))
    assert extras["step"] == 1 and torch.equal(restored["a"], tree["a"])
