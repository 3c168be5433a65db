"""Deterministic, checkpointable synthetic-text data pipeline.

The port's own copy of ``repro.train.data`` (pure NumPy; the port imports
nothing of the JAX package): the same classes and arithmetic, so both packages
draw identical batches from the same (seed, step, shard)
(``tests/test_torch_train.py`` holds them equal).

Production properties kept even though the corpus is synthetic:
  * fully deterministic given (seed, step) — a restart resumes mid-epoch
    exactly (the pipeline *state* is just the step counter, stored in every
    checkpoint);
  * per-host sharding hooks (shard_id / num_shards);
  * background prefetch thread with bounded queue.

The corpus generator produces Zipf-distributed token streams with local
n-gram structure so cross-entropy actually *decreases* during the example
training runs (pure-uniform tokens would pin loss at log V).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    shard_id: int = 0
    num_shards: int = 1
    zipf_a: float = 1.2
    ngram_repeat_p: float = 0.35   # chance to copy token from 7 positions back


class SyntheticLM:
    """Stateless batch generator: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.probs = probs / probs.sum()
        self.perm = rng.permutation(cfg.vocab_size)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_shard = cfg.global_batch // cfg.num_shards
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.shard_id))
        toks = rng.choice(cfg.vocab_size, p=self.probs,
                          size=(per_shard, cfg.seq_len + 1))
        toks = self.perm[toks]
        # inject n-gram structure: with prob p, token t copies t-7
        copy = rng.random((per_shard, cfg.seq_len + 1)) < cfg.ngram_repeat_p
        copy[:, :7] = False
        idx = np.arange(cfg.seq_len + 1)
        src = np.clip(idx - 7, 0, None)
        toks = np.where(copy, toks[:, src], toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class PrefetchIterator:
    """Background-thread prefetch over ``SyntheticLM`` with resumable state."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 prefetch: int = 2):
        self.source = source
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            item = self.source.batch(self._next_to_produce)
            self._next_to_produce += 1
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        self.step += 1
        return item

    def state(self) -> Dict[str, int]:
        """Checkpointable pipeline state."""
        return {"step": self.step}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
