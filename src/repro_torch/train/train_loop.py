"""Training loop: step timing, metrics, checkpoints, restart.

Counterpart of ``repro.train.train_loop``.  ``Trainer`` wires together the
train step (``parallel.steps.make_train_step``, or a setup's over a mesh),
the data pipeline, the async checkpointer and the metrics log, and
implements the same fault-tolerance contract:

  * auto-resume from the latest committed checkpoint (params, optimizer,
    data-pipeline state, step counter);
  * SIGTERM/SIGINT → synchronous final checkpoint before exit (preemption
    safety);
  * per-step wall-time and token-throughput accounting;
  * straggler hook: a callback observing per-step durations; the default
    policy logs p50/p95 and flags steps > ``straggler_factor``×p50.

``Trainer(..., mesh=)`` drives a train setup (``parallel.steps.
make_train_setup``: replicated, zero1 or fsdp over the data axes, tensor
parallelism over ``model``, experts over a data axis) as the JAX ``Trainer``
does: its state starts from the same ``tfm.init`` draw as the one-device
``Trainer``'s, placed by the setup's ``init_state``; every checkpoint holds
the logical state (the setup's ``leaf_to_logical``) and resumes through its
``place_leaf``, so a checkpoint of one mesh resumes on any other, and on one
device (``train.elastic.resume_on_mesh``).  The families are those whose
loss takes tokens alone (dense, moe, ssm, hybrid): ``SyntheticLM`` carries
no patches or frames, in the JAX package as here.

Differences from the JAX package: without a mesh the ``Trainer`` runs the
one-device step (``parallel.steps.make_train_step``) on ``device`` (the
card unless the CPU is asked for); ``mesh`` is keyword-only, after
``device``, and a ``device`` that is not the mesh's raises.  On a
``DistMesh`` the stop flag is agreed at every step boundary (one all-reduce,
``launch.mesh.any_rank``), so that a signal that reaches one rank ends every
rank after the same step (the next step's collectives would otherwise wait
for ever); the rank whose coordinates are all 0 alone writes checkpoints,
prints and keeps ``history``.  The final checkpoint is not written again
where the periodic one was of the same step.  A step's time is read after
``torch.cuda.synchronize`` (before the clock is started and after the step),
since PyTorch returns before the card has finished.
``peak_flops_per_device`` defaults to the dense bf16 peak of one H100 SXM
(989 TFLOP/s, NVIDIA's data sheet, at 700 W), the figure ``chip_smoke.py``
measures MFU against; the JAX package's 197e12 is its TPU's.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..launch.mesh import any_rank
from ..models import transformer as tfm
from ..models.config import ModelConfig, ParallelConfig, ShapeConfig
from ..models.modules import resolve_device
from ..parallel.steps import CellSetup, TrainState, make_train_setup, make_train_step
from . import checkpoint as ckpt
from .data import DataConfig, PrefetchIterator, SyntheticLM
from .optim import OptimConfig, init_adam


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    seed: int = 0
    straggler_factor: float = 2.0
    peak_flops_per_device: float = 989e12    # H100 SXM, dense bf16 (see above)


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 pcfg: Optional[ParallelConfig] = None,
                 ocfg: Optional[OptimConfig] = None,
                 tcfg: Optional[TrainerConfig] = None, *, device=None, mesh=None):
        """``device``: where the one-device step runs, the card unless given;
        ``mesh`` (``launch.mesh``): the setup's ranks instead, on the mesh's
        device."""
        self.tcfg = tcfg or TrainerConfig()
        if mesh is not None and device is not None and \
                torch.device(device) != torch.device(mesh.device):
            raise ValueError(f"Trainer: device {str(device)!r} is not the mesh's device "
                             f"{str(mesh.device)!r}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device or "cuda")
        self.pcfg = pcfg or ParallelConfig()
        self.ocfg = ocfg or OptimConfig()
        self.setup: Optional[CellSetup] = None
        self._to_logical = None             # a checkpoint's leaves from the state
        if mesh is not None:
            self.setup = make_train_setup(cfg, shape, mesh, self.pcfg, self.ocfg)
            self.step_fn = self.setup.step_fn
            self._to_logical = self.setup.leaf_to_logical
        else:
            self.step_fn = make_train_step(cfg, self.pcfg, self.ocfg)
        self.cfg = cfg
        self.shape = shape
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=self.tcfg.seed))
        self.ckpt = ckpt.AsyncCheckpointer(self.tcfg.checkpoint_dir,
                                           keep=self.tcfg.keep_checkpoints, mesh=mesh)
        self.writer = ckpt.is_writer(mesh)
        self.step = 0
        self.history: list[Dict[str, float]] = []
        self._durations: list[float] = []
        self._stop = False

    # ---- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        """The seed's parameters (the same draw with or without a mesh) and
        a fresh optimizer state, placed by the setup on a mesh."""
        pdt = {"bfloat16": torch.bfloat16,
               "float32": torch.float32}[self.pcfg.param_dtype]
        params = tfm.init(self.tcfg.seed, self.cfg, dtype=pdt, device=self.device)
        if self.setup is not None:
            return self.setup.init_state(params)
        return TrainState(params=params, opt=init_adam(params, self.ocfg))

    def resume_or_init(self) -> TrainState:
        latest = ckpt.latest_step(self.tcfg.checkpoint_dir)
        state = self.init_state()
        if latest is not None:
            state, extras = ckpt.restore(
                self.tcfg.checkpoint_dir, state,
                place=self.setup.place_leaf if self.setup is not None else None)
            self.step = int(extras.get("step", latest))
            self._log(f"[trainer] resumed from step {self.step}")
        return state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, line: str) -> None:
        if self.writer:
            print(line)

    # ---- loop ---------------------------------------------------------------
    def run(self, state: Optional[TrainState] = None) -> TrainState:
        t = self.tcfg
        state = state if state is not None else self.resume_or_init()
        it = PrefetchIterator(self.data, start_step=self.step)

        orig_handlers = {}

        def on_signal(signum, frame):
            self._stop = True
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                orig_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:
                pass  # non-main thread

        tokens_per_step = self.shape.global_batch * self.shape.seq_len
        try:
            # the stop flag, on a DistMesh agreed by every rank
            while self.step < t.steps and not any_rank(self.mesh, self._stop):
                batch = next(it)
                self._sync()
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                self._sync()
                dt = time.perf_counter() - t0
                self.step += 1
                self._durations.append(dt)
                self._observe_stragglers()
                if self.writer and (self.step % t.log_every == 0 or self.step == t.steps):
                    row = {k: float(v) for k, v in metrics.items()}
                    row.update(step=self.step, seconds=dt,
                               tokens_per_s=tokens_per_step / dt)
                    self.history.append(row)
                    self._log(f"[trainer] step {self.step} "
                              f"loss={row['loss']:.4f} "
                              f"{row['tokens_per_s']:.0f} tok/s")
                if self.step % t.checkpoint_every == 0:
                    self.ckpt.save(state, step=self.step,
                                   extras={"step": self.step,
                                           "data": it.state()},
                                   to_logical=self._to_logical)
            # final (synchronous) checkpoint — incl. preemption path; not
            # again where the periodic one was of this step
            self.ckpt.wait()
            if self.ckpt.last_saved != self.step:
                ckpt.save(t.checkpoint_dir, state, step=self.step,
                          extras={"step": self.step, "data": it.state()},
                          to_logical=self._to_logical, mesh=self.mesh)
        finally:
            it.close()
            for sig, h in orig_handlers.items():
                signal.signal(sig, h)
        return state

    def _observe_stragglers(self):
        if len(self._durations) < 10:
            return
        recent = np.array(self._durations[-50:])
        p50 = float(np.percentile(recent, 50))
        if self._durations[-1] > self.tcfg.straggler_factor * p50:
            self._log(f"[trainer] straggler step {self.step}: "
                      f"{self._durations[-1]:.3f}s vs p50 {p50:.3f}s")
