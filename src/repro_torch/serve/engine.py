"""Batched serving engine: prefill + decode over one admission batch.

Counterpart of ``repro.serve.engine``: requests are admitted up to the
configured batch, prompts are padded to a common length and run through
``transformer.prefill``, then decode steps run for the whole batch with
per-sequence stop handling and temperature / top-k sampling on the host.

Kept exactly as the JAX engine has it, including what looks odd: prompts are
**left-padded with token 0 and there is no padding mask**, so pad tokens are
attended to and positions start at 0 on the pad.

What differs:

* No ``jax.jit``: the model runs eagerly under ``torch.inference_mode()``.
  A decode step's wall time (``decode_step_s``) ends in
  ``torch.cuda.synchronize()`` where the JAX engine calls
  ``block_until_ready``; ``prefill_s`` is timed the same way.
* Sampling.  The JAX engine seeds each sampled token's numpy generator with
  threefry bits of its PRNG key, which the port cannot reproduce without JAX.
  The port seeds ``np.random.default_rng((seed, step, uid))``, where ``step``
  is 0 for the token sampled from the prefill logits and ``i + 1`` after
  decode step ``i``.  Greedy requests (``temperature <= 0``) give the JAX
  engine's tokens; sampled requests are deterministic under a seed and draw
  from the same probability vector for the same logits, but not the same
  token.
* ``Engine(..., device="cuda")`` is the default and raises when there is no
  CUDA device; the parameters must lie on the engine's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import transformer as tfm
from ..models.config import ModelConfig, ParallelConfig
from ..models.modules import resolve_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    stop_token: Optional[int] = None
    # filled by the engine
    output: Optional[List[int]] = None
    latency_s: float = 0.0


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    cache_len: int = 512
    # serving SLO and traffic: the analytical serving cost model's inputs
    # (core.serving, through a serving Objective), recorded by
    # `launch.dryrun --serving` beside the measured decode latency; the
    # engine does not read them.  None = no SLO attached.
    target_p99_ms: Optional[float] = None
    arrival_rate_rps: Optional[float] = None


def sampling_probs(row: np.ndarray, temperature: float, top_k: int
                   ) -> np.ndarray:
    """The probability vector a sampled request draws from (fp32 logits of
    the real vocabulary in, probabilities out)."""
    row = row / temperature
    if top_k:
        kth = np.partition(row, -top_k)[-top_k]
        row = np.where(row < kth, -np.inf, row)
    p = np.exp(row - row.max())
    p /= p.sum()
    return p


class Engine:
    def __init__(self, params, cfg: ModelConfig,
                 pcfg: Optional[ParallelConfig] = None,
                 ecfg: Optional[EngineConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"parameters lie on {params['embed'].device}, the engine "
                f"runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.pcfg = (pcfg or ParallelConfig()).replace(remat="none")
        self.ecfg = ecfg or EngineConfig()
        # wall times of the most recent run_batch, device work included
        self.prefill_s: float = 0.0
        self.decode_step_s: List[float] = []
        # logits rows of the most recent run_batch that held a NaN or an inf
        self.nonfinite_logit_rows: int = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, reqs: List[Request],
                seed: int, step: int) -> np.ndarray:
        logits = logits.float().cpu().numpy()
        out = np.zeros(len(reqs), np.int32)
        for i, r in enumerate(reqs):
            row = logits[i][:self.cfg.vocab_size]
            self.nonfinite_logit_rows += int(not np.isfinite(row).all())
            if r.temperature <= 0:
                out[i] = int(row.argmax())
                continue
            p = sampling_probs(row, r.temperature, r.top_k)
            out[i] = int(np.random.default_rng((seed, step, r.uid))
                         .choice(len(p), p=p))
        return out

    @torch.inference_mode()
    def run_batch(self, requests: List[Request], seed: int = 0
                  ) -> List[Request]:
        """Serve one admission batch to completion."""
        if len(requests) > self.ecfg.max_batch:
            raise ValueError("admit at most max_batch requests")
        t0 = time.perf_counter()
        self.decode_step_s = []
        self.nonfinite_logit_rows = 0
        B = len(requests)
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        logits, state = tfm.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            self.cfg, self.pcfg, self.ecfg.cache_len)
        self._sync()
        self.prefill_s = time.perf_counter() - t0

        outs: List[List[int]] = [[] for _ in requests]
        done = np.zeros(B, bool)
        max_new = max(r.max_new_tokens for r in requests)
        next_tok = self._sample(logits, requests, seed, 0)
        for step in range(max_new):
            for i, r in enumerate(requests):
                if not done[i]:
                    outs[i].append(int(next_tok[i]))
                    if (r.stop_token is not None and
                            next_tok[i] == r.stop_token) or \
                            len(outs[i]) >= r.max_new_tokens:
                        done[i] = True
            if done.all():
                break
            ts = time.perf_counter()
            tok = torch.from_numpy(next_tok.astype(np.int64))[:, None]
            logits, state = tfm.decode_step(
                self.params, tok.to(self.device), state, self.cfg, self.pcfg)
            self._sync()
            self.decode_step_s.append(time.perf_counter() - ts)
            next_tok = self._sample(logits, requests, seed, step + 1)

        dt = time.perf_counter() - t0
        for r, o in zip(requests, outs):
            r.output = o
            r.latency_s = dt
        return requests
