#!/usr/bin/env python3
"""What ``chip_smoke.py``'s setup cases (t)-(w) should launch and hold,
computed on the CPU without running a model: heads that do not divide the TP
degree and the flash-decoding layout of the decode caches.

    PYTHONPATH=src python3 tools/heads_tp_plan.py

For each case of ``SETUP_HEADS_TRAIN`` / ``SETUP_HEADS_SERVE``, at full width
and the case's depth: the flash and tree-reduce launches from the formulas
the smoke asserts (``expected_train_launches`` / ``expected_launches`` times
the batch rows and ``flash_ranks``, ``tp_tree_launches``, the data sync's
``_synced_blocks``), a rank's padded query heads, and the bytes one rank
holds, from the setups' specs over the parameter and decode-state shapes on
the meta device (a dimension split over n ranks holds ceil(dim / n), as the
flash-decoding layout pads the caches' sequence).  One JSON line a case.
"""

from __future__ import annotations

import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import chip_smoke as cs                                            # noqa: E402
from repro_torch.launch.mesh import make_mesh                      # noqa: E402
from repro_torch.models import transformer as tfm                  # noqa: E402
from repro_torch.models.config import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.models.modules import tree_flatten                # noqa: E402
from repro_torch.parallel.steps import make_setup, make_train_setup  # noqa: E402
from repro_torch.train.optim import OptimConfig, init_adam         # noqa: E402

IS_SPEC = dict(is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields"))


def per_rank_bytes(shapes, specs, mesh) -> int:
    """Bytes of one rank's block of each tensor of ``shapes`` (meta) placed
    by ``specs``: a dimension over n ranks holds ceil(dim / n)."""
    tensors = [t for t in tree_flatten(shapes)[0] if torch.is_tensor(t)]
    spec_list = [s for s in tree_flatten(specs, **IS_SPEC)[0] if isinstance(s, tuple) and s]
    total = 0
    for t, spec in zip(tensors, spec_list):
        dims = list(t.shape)
        for i, e in enumerate(spec):
            if e:
                n = math.prod(mesh.shape[a] for a in ((e,) if isinstance(e, str) else e))
                dims[i] = -(-dims[i] // n)
        total += math.prod(dims) * t.element_size()
    return total


def heads(cfg, tpd):
    hp = -(-cfg.n_heads // tpd)
    return {"query_heads_a_rank": hp, "ranks_with_heads": cs.flash_ranks(cfg, tpd),
            "kv_heads_divide": cfg.n_kv_heads % tpd == 0}


def train_case():
    arch, layers, sharding, (mshape, axes), steps = cs.SETUP_HEADS_TRAIN
    cfg = cs._cut(arch, layers)
    B, S = cs.SETUP_BATCH
    mesh = make_mesh(mshape, axes, device="meta")
    pcfg = ParallelConfig(remat="block", param_dtype="bfloat16", param_sharding=sharding,
                          grad_sync="flat")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, pcfg, OptimConfig())
    tpd = mesh.shape["model"]
    n_rows = mesh.size(setup.ruleset.batch_axes(B))
    launches = {k: v * n_rows * (cs.flash_ranks(cfg, tpd) if k.startswith("flash") else tpd)
                for k, v in cs.expected_train_launches(cfg, pcfg).items() if v}
    launches["tree_reduce"] = (cs.expected_sync_launches("flat", cs._synced_blocks(setup))
                               ["tree_reduce"] + n_rows * cs.tp_tree_launches(cfg, "train",
                                                                            tp=tpd))
    params = tfm.init(None, cfg, dtype=torch.bfloat16, device="meta")
    opt = init_adam(params, OptimConfig())
    return {"case": f"train {arch} {layers} layers {sharding} {dict(zip(axes, mshape))} "
                    f"B {B} x S {S}", **heads(cfg, tpd), "launches_per_step": launches,
            "param_bytes_per_rank": per_rank_bytes(params, setup.param_shardings, mesh),
            "opt_bytes_per_rank": per_rank_bytes([opt.master, opt.m, opt.v],
                                                 [setup.state_shardings.opt.master,
                                                  setup.state_shardings.opt.m,
                                                  setup.state_shardings.opt.v], mesh)}


def serve_case(arch, layers, prompt, cache_len, B, mesh_spec, new, lengths):
    cfg = cs._cut(arch, layers) if layers else cs.get_config(arch)
    mesh = make_mesh(*mesh_spec, device="meta")
    pcfg = ParallelConfig(param_dtype="bfloat16")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", cache_len, B), mesh, pcfg)
    tpd = mesh.shape["model"]
    b_axes = pre.ruleset.batch_axes(B) or ()
    n_rows = mesh.size(b_axes)
    seq = (cfg.n_kv_heads % tpd != 0) or not b_axes
    prefill = {k: v * n_rows * (cs.flash_ranks(cfg, tpd) if k.startswith("flash") else tpd)
               for k, v in cs.expected_launches(cfg).items() if v}
    prefill["tree_reduce"] = n_rows * cs.tp_tree_launches(cfg, "prefill", tp=tpd)
    state = tfm.init_decode_state(cfg, B, cache_len, torch.bfloat16, device="meta")
    params = tfm.init(None, cfg, dtype=torch.bfloat16, device="meta")
    return {"case": f"serve {arch} {layers or cfg.num_layers} layers {dict(zip(*mesh_spec[::-1]))}"
                    f" B {B} x {prompt}, cache {cache_len}, {new} steps",
            **heads(cfg, tpd), "flash_decoding": seq,
            "cache_sequence_over": pre.state_shardings.kv.k[2],
            "prefill_launches": prefill,
            "decode_tree_reduces": new * n_rows * cs.tp_tree_launches(cfg, "decode", tp=tpd,
                                                                      seq=seq),
            "param_bytes_per_rank": per_rank_bytes(params, pre.param_shardings, mesh),
            "decode_state_bytes_per_rank": per_rank_bytes(state, pre.state_shardings, mesh),
            "decode_state_bytes_whole": per_rank_bytes(state, pre.state_shardings, make_mesh(
                (1,) * len(mesh_spec[0]), mesh_spec[1], device="meta"))}


def main() -> int:
    print(json.dumps(train_case()))
    for case in cs.SETUP_HEADS_SERVE:
        print(json.dumps(serve_case(*case)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
