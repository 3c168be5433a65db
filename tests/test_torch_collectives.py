"""The port's gradient synchronisation on the CPU, held against the JAX package.

(a) ``build_sync`` of the JAX package runs on 8 host devices in one
    subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
    ``tests/test_multidevice.py`` runs it), over meshes (pod, data) of (2, 4),
    (4, 2), (1, 8) and (2, 4) without an outer axis, in every mode, fp32 and
    bf16, on one tree: the JAX test's leaves, leaves of 1, 4097 and 3001
    elements, and the reduced llama3.2-1b parameter tree.  The port's stacked
    transport (every replica on the CPU, the plain kernels) is held to it.
    Tolerances: flat and hierarchical within ``tol(dtype)`` (XLA sums in
    another order); compressed within one quantum per element (the scale of
    that element's block, summed over the pods and divided by the replica
    count) plus ``tol(dtype)``, because one ulp of difference in the
    reduce-scatter can move a value across a rounding tie of the quantizer.
    The new error buffers have JAX's shapes and are held to one scale of
    their block plus the rounding of the carry.  The JAX functions run under
    ``jax.jit``: eagerly, compressed mode without an outer axis raises on the
    sharding of its empty ``(R, 0)`` error placeholder (ROADMAP Queue 3).
(b) The error-feedback property over 20 steps (``test_multidevice.py``'s
    ``test_error_feedback_reduces_bias_over_steps``) on the stacked transport.
(c) The distributed transport: one spawned world of 8 ``gloo`` ranks on a
    (2, 4) mesh gives, on every rank, exactly the stacked transport's result
    (the same shards combined by the same plain tree).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch.mesh import fred_device_order as j_fred_device_order

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (StackedMesh, fred_device_order, make_dist_mesh,
                                     make_mesh)
from repro_torch.models import transformer as tfm
from repro_torch.parallel import compress
from repro_torch.parallel.collectives import (MODES, _pad_to, build_sync,
                                              init_error_feedback)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
AXES = ("pod", "data")
# (mesh shape, outer axis) of the JAX runs; the replica count is |pod|*|data|
# with an outer axis and |data| without one
MESHES = [((2, 4), "pod"), ((4, 2), "pod"), ((1, 8), "pod"), ((2, 4), None)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-4)


def tree_shapes():
    """Leaf name → per-replica shape: the JAX test's two leaves, three sizes
    that need padding, and the reduced llama3.2-1b parameter tree."""
    shapes = {"mixed.a": (4, 6), "mixed.b": (7,), "mixed.one": (1,),
              "mixed.odd": (4097,), "mixed.rect": (3001,)}
    params = tfm.init(0, get_config("llama3.2-1b").reduced(), device="cpu")

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(f"{prefix}.{i}", v)
        else:
            shapes[prefix] = tuple(t.shape)
    walk("llama", params)
    return shapes


def rows(shape, outer):
    return shape[1] * (shape[0] if outer else 1)


def make_inputs():
    """Replica-stacked gradients (8 replicas; a run with fewer takes the
    first rows) and per-mesh error buffers, from one seed.  bf16 runs use
    the same values rounded to bf16 on both sides."""
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in tree_shapes().items():
        if name in ("mixed.a", "mixed.b"):      # the JAX test's g * (1 + i)
            base = (np.arange(24, dtype=np.float32).reshape(4, 6) if name == "mixed.a"
                    else np.linspace(-1, 1, 7, dtype=np.float32))
            g = np.stack([base * (1.0 + i) for i in range(8)])
        else:
            g = rng.standard_normal((8,) + shape, np.float32)
        out[f"g|{name}"] = g
        for mid, (mshape, outer) in enumerate(MESHES):
            s = -(-math.prod(shape) // mshape[1])
            out[f"e{mid}|{name}"] = \
                rng.standard_normal((rows(mshape, outer), s), np.float32) * 0.05
    return out


def grads_for(inputs, mid, dtype, device="cpu"):
    R = rows(*MESHES[mid])
    td = DTYPES[dtype]
    g = {k[2:]: torch.from_numpy(v[:R]).to(device=device, dtype=td)
         for k, v in inputs.items() if k.startswith("g|")}
    e = {k: torch.from_numpy(inputs[f"e{mid}|{k}"]).to(device) for k in g}
    return g, e


JAX_RUN = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.parallel.collectives import build_sync
MESHES = {meshes!r}
inp = dict(np.load(sys.argv[1]))
out = {{}}
for mid, (shape, outer) in enumerate(MESHES):
    mesh = make_mesh(shape, ("pod", "data"))
    R = shape[1] * (shape[0] if outer else 1)
    for dname, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        grads = {{k[2:]: jnp.asarray(v[:R]).astype(dt)
                  for k, v in inp.items() if k.startswith("g|")}}
        errs = {{k: jnp.asarray(inp[f"e{{mid}}|{{k}}"]) for k in grads}}
        with mesh:
            for mode in ("flat", "hierarchical", "compressed"):
                # under jit: eagerly, compressed without an outer axis
                # raises on the sharding of its empty error placeholder
                sync = jax.jit(build_sync(mesh, mode, "data", outer))
                if mode == "compressed":
                    res, new = sync(grads, errs)
                    for k in grads:
                        out[f"{{mid}}|{{mode}}|{{dname}}|err|{{k}}"] = \\
                            np.asarray(new[k].astype(jnp.float32))
                else:
                    res = sync(grads)
                for k in grads:
                    out[f"{{mid}}|{{mode}}|{{dname}}|out|{{k}}"] = \\
                        np.asarray(res[k].astype(jnp.float32))
np.savez(sys.argv[2], **out)
print("JAX_SYNC_OK", len(out))
"""


@pytest.fixture(scope="module")
def sync_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sync")
    inputs = make_inputs()
    np.savez(d / "inputs.npz", **inputs)
    return d, inputs


@pytest.fixture(scope="module")
def jax_sync(sync_inputs):
    d, _ = sync_inputs
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN.format(meshes=MESHES), str(d / "inputs.npz"),
         str(d / "jax.npz")], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"JAX subprocess failed:\n{proc.stderr[-3000:]}"
    return dict(np.load(d / "jax.npz"))


def carry_scales(mesh, g, e, outer):
    """The scales the port's quantizer gives every rank's carry, local form
    ``(P, D, nb)``: one quantum of each block, for the tolerance."""
    axes = (outer, "data")
    xp, _ = _pad_to(mesh.local(g, axes), mesh.shape["data"])
    shard = ops.reduce_shards(mesh.exchange(xp, ("data",)))
    carry = shard + mesh.local(e, axes)
    return carry, compress.quantize(carry)[1]


@pytest.mark.parametrize("part", ["mixed", "llama"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mid", range(len(MESHES)),
                         ids=[f"{s[0]}x{s[1]}-{o}" for s, o in MESHES])
def test_stacked_sync_matches_jax_build_sync(jax_sync, sync_inputs, mid, mode, dtype, part):
    shape, outer = MESHES[mid]
    mesh = make_mesh(shape, AXES, device="cpu")
    grads, errs = grads_for(sync_inputs[1], mid, dtype)
    sync = build_sync(mesh, mode, "data", outer)
    if mode == "compressed":
        out, new = sync(grads, errs)
    else:
        out, new = sync(grads), None
    D, n_total = shape[1], rows(shape, outer)
    names = [k for k in grads if k.startswith(part + ".")]
    assert names
    for k in names:
        got = out[k]
        assert got.dtype == DTYPES[dtype] and got.shape == grads[k].shape[1:], k
        got = got.float().numpy()
        want = jax_sync[f"{mid}|{mode}|{dtype}|out|{k}"]
        if mode != "compressed" or outer is None:
            np.testing.assert_allclose(got, want, **tol(dtype), err_msg=k)
            if new is not None:         # the placeholder of collectives.py:79
                assert tuple(new[k].shape) == (n_total, 0) and new[k].dtype == DTYPES[dtype]
                assert jax_sync[f"{mid}|{mode}|{dtype}|err|{k}"].shape == (n_total, 0)
            continue
        carry, scales = carry_scales(mesh, grads[k], errs[k], outer)
        size, s = got.size, carry.shape[-1]
        j = np.arange(size)
        blk = (j % s) // compress.BLOCK
        quantum = scales.sum(0).numpy()[j // s, blk] / n_total
        t = tol(dtype)
        bound = quantum + t["atol"] + t["rtol"] * np.abs(want.reshape(-1))
        diff = np.abs(got.reshape(-1) - want.reshape(-1))
        assert (diff <= bound).all(), (k, float(diff.max()))
        # new error buffers: JAX's shapes, within one scale of their block
        want_e = jax_sync[f"{mid}|{mode}|{dtype}|err|{k}"]
        got_e = new[k]
        assert got_e.dtype == torch.float32 and tuple(got_e.shape) == want_e.shape == \
            (n_total, s), k
        ulp = 2.0 ** (-7 if dtype == "bfloat16" else -21)
        e_bound = (scales.reshape(n_total, -1).repeat_interleave(compress.BLOCK, 1)[:, :s]
                   + ulp * carry.abs().reshape(n_total, s) + 1e-6).numpy()
        assert (np.abs(got_e.numpy() - want_e) <= e_bound).all(), k


def test_error_feedback_tracks_the_exact_sum_over_20_steps():
    """test_multidevice.py::test_error_feedback_reduces_bias_over_steps on the
    stacked transport: the accumulated compressed sum tracks the exact one."""
    mesh = make_mesh((2, 4), AXES, device="cpu")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 1024), np.float32) * 0.1)
    sync = build_sync(mesh, "compressed", "data", "pod")
    errs = init_error_feedback({"g": (1024,)}, mesh)
    assert tuple(errs["g"].shape) == (8, 256)
    exact = g.mean(0)
    acc_c = torch.zeros(1024)
    acc_e = torch.zeros(1024)
    for _ in range(20):
        out, errs = sync({"g": g}, errs)
        acc_c += out["g"]
        acc_e += exact
    rel = float((acc_c - acc_e).norm() / acc_e.norm())
    assert rel < 5e-3, rel
    assert float(errs["g"].abs().max()) > 0


def test_mesh_layouts_round_trip_and_follow_the_replica_order():
    mesh = make_mesh((2, 4), AXES, device="cpu")
    g = torch.arange(8 * 6.0).reshape(8, 2, 3)
    loc = mesh.local(g, ("pod", "data"))
    assert tuple(loc.shape) == (2, 4, 6) and loc.data_ptr() == g.data_ptr()
    assert torch.equal(loc[1, 2], g[1 * 4 + 2].reshape(-1))     # replica pod-major
    assert torch.equal(mesh.stacked(loc, ("pod", "data")), g.reshape(8, 6))
    # axes in another order than the mesh's: replica index data-major
    loc_dm = mesh.local(g, ("data", "pod"))
    assert torch.equal(loc_dm[1, 2], g[2 * 2 + 1].reshape(-1))
    assert torch.equal(mesh.stacked(loc_dm, ("data", "pod")), g.reshape(8, 6))
    # only the data axis: pods replicated (size-1 leading dimension)
    assert tuple(mesh.local(g[:4], ("data",)).shape) == (1, 4, 6)
    # exchange: what rank (p, r) received from rank (p, src) is src's chunk r
    x = torch.arange(8 * 8.0).reshape(2, 4, 8)
    got = mesh.exchange(x, ("data",))
    assert tuple(got.shape) == (2, 4, 4, 2)
    assert torch.equal(got[1, 3, 2], x[1, 2, 6:8])
    # gather over pods: (1, D, P, m), equal on every pod
    gath = mesh.gather(x, ("pod",))
    assert tuple(gath.shape) == (1, 4, 2, 8)
    assert torch.equal(gath[0, 3, 1], x[1, 3])
    with pytest.raises(ValueError, match="replica"):
        mesh.local(g[:5], ("pod", "data"))
    with pytest.raises(ValueError, match="replicated"):
        mesh.replicated(x)
    with pytest.raises(ValueError, match="mode"):
        build_sync(mesh, "ring")


def test_meshes_ask_for_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh((2, 4), AXES)
    assert isinstance(make_mesh((2, 4), AXES, device="cpu"), StackedMesh)
    # the distributed mesh needs an initialised world of the mesh's size
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_dist_mesh((2, 4), AXES, device="cpu")
    mesh = make_mesh((2, 4), AXES, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        build_sync(mesh, "flat", "data", "pod")({"g": torch.zeros(8, 3, device="meta")})


@pytest.mark.parametrize("n,mp,dp,pp", [(8, 2, 2, 2), (16, 4, 2, 2), (12, 3, 2, 2), (6, 1, 6, 1)])
def test_fred_device_order_copy_equals_jax(n, mp, dp, pp):
    np.testing.assert_array_equal(fred_device_order(n, mp, dp, pp),
                                  j_fred_device_order(n, mp, dp, pp))


GLOO_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.parallel.collectives import build_sync
rank, store, inputs, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=8)
mesh = make_dist_mesh((2, 4), ("pod", "data"), device="cpu")
r = mesh.replica(("pod", "data"))
inp = dict(np.load(inputs))
out = {"replica": np.array(r)}
for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
    grads = {k[2:]: torch.from_numpy(v[r:r + 1]).to(dt)
             for k, v in inp.items() if k.startswith("g|")}
    errs = {k: torch.from_numpy(inp["e0|" + k][r:r + 1]) for k in grads}
    for mode in ("flat", "hierarchical", "compressed"):
        sync = build_sync(mesh, mode, "data", "pod")
        if mode == "compressed":
            res, new = sync(grads, errs)
            for k in grads:
                out[f"{mode}|{dname}|err|{k}"] = new[k].numpy()
        else:
            res = sync(grads)
        for k in grads:
            out[f"{mode}|{dname}|out|{k}"] = res[k].float().numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_sync(sync_inputs):
    d, _ = sync_inputs
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(rank), str(d / "gloo_store"),
         str(d / "inputs.npz"), str(d / f"gloo_{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(8)]
    try:
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    bad = [(i, err[-2000:]) for i, (p, (_, err)) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"gloo ranks failed: {bad}"
    return [dict(np.load(d / f"gloo_{rank}.npz")) for rank in range(8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_gloo_transport_equals_the_stacked_one(gloo_sync, sync_inputs, mode, dtype):
    mesh = make_mesh((2, 4), AXES, device="cpu")
    grads, errs = grads_for(sync_inputs[1], 0, dtype)
    sync = build_sync(mesh, mode, "data", "pod")
    out, new = sync(grads, errs) if mode == "compressed" else (sync(grads), None)
    assert sorted(int(r["replica"]) for r in gloo_sync) == list(range(8))
    for res in gloo_sync:
        r = int(res["replica"])
        for k in grads:
            np.testing.assert_array_equal(res[f"{mode}|{dtype}|out|{k}"],
                                          out[k].float().numpy(), err_msg=k)
            if new is not None:
                np.testing.assert_array_equal(res[f"{mode}|{dtype}|err|{k}"],
                                              new[k][r:r + 1].numpy(), err_msg=k)
