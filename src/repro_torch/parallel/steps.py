"""The training step on one device.

Counterpart of ``repro.parallel.steps.make_train_setup`` (its ``train_step``:
``jax.value_and_grad`` of ``loss_fn``, then ``adam_update``), without the
mesh, and of ``moe_ep_ffn_fn``, which binds the expert-parallel FFN to a
``parallel.sharding.Ruleset``.  The input specs, the parameter and optimizer
placements and the train / prefill / decode setups over a mesh wait for
ROADMAP.md M9b.

``make_train_step(cfg, pcfg, ocfg)`` returns ``step(state, batch) ->
(state, metrics)``: the loss of the batch, its gradient by ``backward``
through the model (on the card every self-attention's through the
flash-attention backward kernel, every Mamba2 scan's through the SSD-scan
backward kernel), then AdamW.  The parameters and the
optimizer state are updated in place (``train.optim``), so the returned
``TrainState`` holds the tensors of the one passed in.  Metrics, as in the
JAX step: ``loss``, ``aux_loss``, ``tokens``, ``grad_norm``, ``lr`` (0-d
tensors; reading one waits for the step).  A vlm batch carries
``patch_embeds`` (B, n_patches, d) and its ``tokens`` / ``labels`` the text
after them; an audio batch carries ``frames`` (B, enc_seq, d), which the step
encodes through ``_enc_fn``, as the JAX ``make_train_setup`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import transformer as tfm
from ..models import whisper
from ..models.moe import moe_ffn_ep
from ..models.config import ModelConfig, ParallelConfig
from ..models.modules import tree_flatten, tree_unflatten
from ..train.optim import AdamState, OptimConfig, adam_update
from .sharding import Ruleset


class TrainState(NamedTuple):
    params: Any
    opt: AdamState


INTEGER_INPUTS = ("tokens", "labels")


def batch_to_device(batch: Dict[str, Any], device, dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``: the token
    ids and labels as int64, the embeddings (``patch_embeds``, ``frames``) in
    ``dtype``, the parameters' dtype, as the JAX ``input_specs`` gives them the
    compute dtype."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else v).to(device=device,
                           dtype=torch.int64 if k in INTEGER_INPUTS else dtype)
            for k, v in batch.items()}


def _enc_fn(cfg: ModelConfig, pcfg: ParallelConfig):
    """The encoder of an audio model as ``loss_fn`` / ``prefill`` take it, or
    None for the other families."""
    if cfg.family != "audio":
        return None
    return lambda p, b: whisper.encode(p, b, cfg, pcfg)


def make_train_step(cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
                    ocfg: Optional[OptimConfig] = None
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    pcfg = pcfg or ParallelConfig()
    ocfg = ocfg or OptimConfig()
    enc_fn = _enc_fn(cfg, pcfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves, spec = tree_flatten(state.params)
        # the same storage, as leaves of a fresh autograd graph
        live = [p.detach().requires_grad_() for p in leaves]
        batch = batch_to_device(batch, leaves[0].device, leaves[0].dtype)
        total, metrics = tfm.loss_fn(tree_unflatten(spec, live), batch, cfg, pcfg,
                                     enc_fn=enc_fn)
        total.backward()
        grads = [p.grad for p in live]
        del live, total
        params, opt, om = adam_update(state.params, tree_unflatten(spec, grads),
                                      state.opt, ocfg)
        return TrainState(params, opt), {**metrics, **om}

    return train_step


def moe_ep_ffn_fn(ruleset: Ruleset, cfg: ModelConfig):
    """Bind the all-to-all expert dispatch to a cell: ``f(params_ffn, x) ->
    (out, aux)`` runs ``models.moe.moe_ffn_ep`` on the ruleset's mesh over its
    EP axis (``pcfg.moe_ep_axis``), x and the expert weights in the rows form
    over that axis (``parallel.sharding.shard_leaf``).  Raises ``ValueError``
    when the ruleset has no EP axis: expert parallelism is a decision of the
    configuration, never a silent fallback."""
    if not ruleset.ep_axis:
        raise ValueError(
            "moe_ep_ffn_fn: the cell's ParallelConfig.moe_ep_axis is unset "
            "or invalid for this mesh / model; expert parallelism needs a "
            "data axis whose size divides n_experts")

    def f(params_ffn, x):
        return moe_ffn_ep(params_ffn, x, cfg, mesh=ruleset.mesh, ep_axis=ruleset.ep_axis)
    return f
