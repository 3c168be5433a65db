"""What a call of a hand-written kernel costs, reported to a cost counter.

A kernel launched through ``ctypes`` is invisible to a ``TorchDispatchMode``,
and the plain version that stands in for it on the CPU is a loop of tensor
ops whose count is not the kernel's.  So each call site of ``kernels.ops``
(and the two ``autograd.Function`` s, forward and backward) runs the call
``muted()`` and then ``report`` s the kernel's own work: the FLOPs and bytes
of the formula beside its wrapper (``flash_fwd_work``, ``ssd_fwd_work``, ...,
the formulas ``chip_smoke.py``'s bounds read).  The same call then counts the
same on the card and on the CPU.

``counter`` is ``launch.roofline.count_cost``'s counter while it counts, else
None; with none active, ``report`` and ``muted`` cost one ``None`` check.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

counter = None


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    """Bytes of the tensors, each element once (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def report(work: Callable, *args, **kwargs) -> None:
    """Add ``work(*args, **kwargs)`` = (flops, bytes) to the active counter."""
    if counter is not None:
        flops, n = work(*args, **kwargs)
        counter.add(flops, n, work.__name__)


class muted:
    """While inside, the active counter counts no tensor op: the kernel's
    wrapper (or its plain version) runs, and ``report`` counts it."""

    def __enter__(self):
        self.c = counter
        if self.c is not None:
            self.c.muted += 1

    def __exit__(self, *exc):
        if self.c is not None:
            self.c.muted -= 1
