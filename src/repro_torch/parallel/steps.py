"""The training step on one device.

Counterpart of ``repro.parallel.steps.make_train_setup`` (its ``train_step``:
``jax.value_and_grad`` of ``loss_fn``, then ``adam_update``), without the
mesh: the sharding rules, input specs and the prefill / decode setups of that
module arrive with the multi-rank slice (ROADMAP.md M9).

``make_train_step(cfg, pcfg, ocfg)`` returns ``step(state, batch) ->
(state, metrics)``: the loss of the batch, its gradient by ``backward``
through the model (on the card every self-attention's through the
flash-attention backward kernel, every Mamba2 scan's through the SSD-scan
backward kernel), then AdamW.  The parameters and the
optimizer state are updated in place (``train.optim``), so the returned
``TrainState`` holds the tensors of the one passed in.  Metrics, as in the
JAX step: ``loss``, ``aux_loss``, ``tokens``, ``grad_norm``, ``lr`` (0-d
tensors; reading one waits for the step).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import transformer as tfm
from ..models.config import ModelConfig, ParallelConfig
from ..models.modules import tree_flatten, tree_unflatten
from ..train.optim import AdamState, OptimConfig, adam_update


class TrainState(NamedTuple):
    params: Any
    opt: AdamState


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors (token ids, labels) as int64 tensors
    on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
                    ocfg: Optional[OptimConfig] = None
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    pcfg = pcfg or ParallelConfig()
    ocfg = ocfg or OptimConfig()

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves, spec = tree_flatten(state.params)
        # the same storage, as leaves of a fresh autograd graph
        live = [p.detach().requires_grad_() for p in leaves]
        batch = batch_to_device(batch, leaves[0].device)
        total, metrics = tfm.loss_fn(tree_unflatten(spec, live), batch, cfg, pcfg)
        total.backward()
        grads = [p.grad for p in live]
        del live, total
        params, opt, om = adam_update(state.params, tree_unflatten(spec, grads),
                                      state.opt, ocfg)
        return TrainState(params, opt), {**metrics, **om}

    return train_step
