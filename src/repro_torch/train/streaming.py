"""Weight streaming (paper Sec. III-A): train a model whose parameters live in
host memory, one layer on the card at a time.

Counterpart of ``repro.train.streaming``, with its public names:
``HostParams``, ``stream_forward``, ``stream_grads``, ``stream_train_step``.
The parameters live in host memory (the paper's off-chip DRAM).  Each block
crosses the link to the card for the forward and again for the backward's
recompute; its gradient crosses back, and a host thread (the paper's
near-storage core) updates the host weights, so no optimizer state ever
reaches the card.

The schedule on a CUDA device (``HostParams(..., device="cuda")``, the
default; every host buffer is pinned, asserted at each copy):

  * **Host layout.**  Each layer is one flat buffer per dtype, its leaves
    views of it, pinned by ``cudaHostRegister`` at its exact size (the
    caching host allocator behind ``pin_memory=True`` may round a size up to
    a power of two and keeps freed blocks).  The leaves outside the blocks
    (the top: embedding, final norm, head) are one more such buffer.
  * **Device slots.**  A ring of one or two slots, each one layer's flat
    buffers, allocated at the first pass and kept until ``close()``.  Two
    when two layers, one layer's gradient and the pass's working set fit the
    card's free memory, else one (no overlap); ``stats["slots_why"]`` says
    which.  A slot that still holds the layer the next block needs is not
    copied again (the last layers of the forward are the first of the
    backward).
  * **Forward.**  Layer l+1's host-to-device copy runs on a copy stream
    while layer l computes; an event orders each copy before its block, and
    a second keeps a copy from writing a slot that a kernel still reads.
  * **Backward.**  Layer l−1's copy overlaps layer l's recompute and
    backward.  Layer l's gradient goes device-to-host on a second stream,
    chunk by chunk, through a ring of ``STAGING_CHUNKS`` pinned staging
    chunks of ``STAGING_BYTES`` (or of one layer, if that is smaller); a
    worker thread waits on each chunk's event and updates the matching slice
    of layer l's host weights while the card runs layer l−1.  At most one
    layer's gradient is on the card: the backward of layer l−1 starts its
    products once layer l's gradient has left.
  * **The top** crosses the link once a pass each way.

On the CPU (``device="cpu"``, which only the tests name) the same schedule
runs with plain copies.  On a CUDA device nothing falls back to the CPU: the
blocks launch the kernels through ``kernels.ops`` as ``loss_fn`` does.

Differences from the reference (ROADMAP.md Queue 3, "Deliberate
differences"):

  * **MoE matches ``loss_fn``.**  The reference's streamed loss leaves out
    ``router_aux_weight * Σ aux``; here a block returns its router aux loss,
    the streamed total is ``loss_fn``'s total and each block's backward takes
    the aux cotangent, so the gradients are ``loss_fn``'s.
  * **Refused** (``ValueError``): the hybrid family (the reference skips
    zamba2's shared block, so its loss is not ``loss_fn``'s), the audio
    family (no encoder in the stream), a vlm batch with ``patch_embeds``, and
    ``tp=`` / ``ep=`` / ``mesh=`` (the reference streams on one device).  A
    tokens-only vlm batch runs as the dense family.
  * **The update** is the reference's plain SGD in the weights' dtype, bit
    for bit (``sgd_update``), but each layer is updated as its gradient
    lands, the top last, instead of after every gradient is on the host: the
    host never holds all the gradients at once.  Layer l's weights are not
    read again in the step once its gradient exists, so the result is the
    same.
  * The blocks run without ``_maybe_remat``: the backward's recompute is the
    remat.  ``stream_forward`` / ``stream_grads`` return the total as a
    detached 0-dim tensor on the device, the gradients on the host.
"""

from __future__ import annotations

import contextlib
import math
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models import transformer as tfm
from ..models.config import ModelConfig, ParallelConfig
from ..models.layers import apply_attn_block
from ..models.modules import (resolve_device, rms_norm, softmax_cross_entropy, tree_flatten,
                              tree_unflatten)
from ..models.ssm import mamba2_forward

STAGING_BYTES = 256 << 20      # one pinned staging chunk of the gradient stream
STAGING_CHUNKS = 2             # the ring: one chunk copies while the other is updated
HOST_MARGIN_BYTES = 4 << 30    # host memory left free when pinning
WORK_RESERVE_BYTES = 6 << 30   # device memory kept for a block's working set
UPDATE_ELEMENTS = 1 << 20      # the host update's slice (its fp32 temporary stays in the caches)
_ALIGN = 64


# --------------------------------------------------------------------------
# host memory
# --------------------------------------------------------------------------

def mem_available_bytes() -> int:
    """``MemAvailable`` of ``/proc/meminfo``: what the host can still give."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable line in /proc/meminfo")


class _Pinned:
    """``nbytes`` of host memory, page-locked by ``cudaHostRegister`` at
    exactly that size; ``close()`` unregisters it."""

    def __init__(self, nbytes: int):
        self.tensor = torch.empty(max(nbytes, 1), dtype=torch.uint8)
        self.nbytes = nbytes
        err = torch.cuda.cudart().cudaHostRegister(self.tensor.data_ptr(), self.tensor.numel(), 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: error {int(err)}")
        if not self.tensor.is_pinned():
            raise RuntimeError(f"cudaHostRegister returned, but {nbytes} bytes are not pinned")

    def close(self):
        if self.tensor is not None:
            torch.cuda.cudart().cudaHostUnregister(self.tensor.data_ptr())
            self.tensor = None


def _require_pinned(t: torch.Tensor, what: str):
    if not t.is_pinned():
        raise RuntimeError(f"{what} is pageable: a non-blocking copy from it would be "
                           f"synchronous, so nothing would overlap")


# --------------------------------------------------------------------------
# flat layout of a parameter tree
# --------------------------------------------------------------------------

class _Layout:
    """Where each leaf of a tree lives in one flat buffer per dtype: the
    buffers' sizes, each leaf's (dtype, offset, shape), and the chunks of the
    gradient stream."""

    def __init__(self, tree):
        leaves, self.spec = tree_flatten(tree)
        self.sizes: Dict[torch.dtype, int] = {}
        self.places: List[Tuple[torch.dtype, int, Tuple[int, ...]]] = []
        for t in leaves:
            off = self.sizes.get(t.dtype, 0)
            self.places.append((t.dtype, off, tuple(t.shape)))
            self.sizes[t.dtype] = off + t.numel()
        # each dtype's buffer at an aligned byte offset of one allocation
        self.starts: Dict[torch.dtype, int] = {}
        pos = 0
        for dt, n in self.sizes.items():
            self.starts[dt] = pos
            pos += -(-n * dt.itemsize // _ALIGN) * _ALIGN
        self.nbytes = pos
        self._chunks: Dict[int, list] = {}

    def same_as(self, tree) -> bool:
        leaves, spec = tree_flatten(tree)
        return spec == self.spec and [(t.dtype, tuple(t.shape)) for t in leaves] == \
            [(d, s) for d, _, s in self.places]

    def buffers(self, raw: torch.Tensor) -> Dict[torch.dtype, torch.Tensor]:
        """The dtype buffers inside one uint8 allocation of ``nbytes``."""
        return {dt: raw[self.starts[dt]:self.starts[dt] + n * dt.itemsize].view(dt)
                for dt, n in self.sizes.items()}

    def leaf_views(self, bufs) -> List[torch.Tensor]:
        return [bufs[dt][off:off + math.prod(shape)].view(shape)
                for dt, off, shape in self.places]

    def views(self, bufs):
        return tree_unflatten(self.spec, self.leaf_views(bufs))

    def chunks(self, chunk_bytes: int):
        """The gradient stream's chunks: (dtype, a, b, pieces), [a, b) a range
        of the dtype's flat buffer, each piece (leaf index, lo, hi) a range of
        a leaf's flat elements, in order."""
        if chunk_bytes not in self._chunks:
            out = []
            for dt, n in self.sizes.items():
                step = max(chunk_bytes // dt.itemsize, 1)
                leaves = [(i, off, math.prod(shape))
                          for i, (d, off, shape) in enumerate(self.places) if d == dt]
                for a in range(0, n, step):
                    b = min(a + step, n)
                    pieces = [(i, max(a, off) - off, min(b, off + k) - off)
                              for i, off, k in leaves if off < b and off + k > a]
                    out.append((dt, a, b, pieces))
            self._chunks[chunk_bytes] = out
        return self._chunks[chunk_bytes]


# --------------------------------------------------------------------------
# host parameters
# --------------------------------------------------------------------------

class HostParams:
    """The parameters in host memory, one flat buffer per layer and dtype,
    sliced per layer for streaming.

    ``params`` is the port's parameter tree; ``params["blocks"]`` a list of
    ``n_layers`` block trees, or a function of the layer index that returns
    one (so that a model too large for the card is drawn one layer at a
    time: each is copied into its host buffer and dropped).  ``device`` is
    where the blocks run (``models.modules.resolve_device``: the card unless
    the caller names the CPU); on a CUDA device the host buffers are pinned.
    The first pass chooses the ring's size (``_choose_slots``).  ``host`` is
    the tree of host leaves (views of the buffers), in the layout of
    ``params``.  ``stats`` describes the last pass.  Call
    ``close()`` (or use ``with``) to release the pinned memory and the slots.
    """

    def __init__(self, params: Dict[str, Any], n_layers: int, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"weight streaming runs on a CUDA device or the CPU, not {device!r}")
        blocks = params["blocks"]
        if not callable(blocks) and len(blocks) != n_layers:
            raise ValueError(f"n_layers {n_layers}, but params['blocks'] holds {len(blocks)}")
        if n_layers < 1:
            raise ValueError("weight streaming needs at least one layer")
        get = blocks if callable(blocks) else blocks.__getitem__
        self.n_layers = n_layers
        self._pinned: List[_Pinned] = []
        self._slots = None          # device slots: list of dtype -> flat buffer
        self._top_dev = None
        self._staging = None
        self._streams = None
        self.stats: Dict[str, Any] = {}
        try:
            top = {k: v for k, v in params.items() if k != "blocks"}
            self._top_layout = _Layout(top)
            first = get(0)
            self._layout = _Layout(first)
            # a staging chunk need not be larger than the largest buffer it drains
            self._chunk_bytes = min(STAGING_BYTES, max(self._layout.nbytes,
                                                       self._top_layout.nbytes))
            want = self._top_layout.nbytes + n_layers * self._layout.nbytes
            if self.device.type == "cuda":
                want += STAGING_CHUNKS * self._chunk_bytes
                avail = mem_available_bytes()
                if want + HOST_MARGIN_BYTES > avail:
                    raise MemoryError(f"weight streaming would pin {want} bytes of host memory "
                                      f"and keep {HOST_MARGIN_BYTES} free; MemAvailable is "
                                      f"{avail}")
            self.pinned_bytes = want if self.device.type == "cuda" else 0
            self._top_host = self._host_buffers(self._top_layout)
            self._fill(self._top_layout, self._top_host, top)
            self._blocks_host = []
            for i in range(n_layers):
                tree = first if i == 0 else get(i)
                if not self._layout.same_as(tree):
                    raise ValueError(f"block {i} differs from block 0 in its leaves, "
                                     f"shapes or dtypes")
                bufs = self._host_buffers(self._layout)
                self._fill(self._layout, bufs, tree)
                self._blocks_host.append(bufs)
                del tree
            first = None
        except BaseException:
            self.close()
            raise
        self.host = {**self._top_layout.views(self._top_host),
                     "blocks": [self._layout.views(b) for b in self._blocks_host]}

    # ---- buffers ---------------------------------------------------------

    def _raw(self, nbytes: int) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.empty(max(nbytes, 1), dtype=torch.uint8)
        p = _Pinned(nbytes)
        self._pinned.append(p)
        return p.tensor

    def _host_buffers(self, layout: _Layout):
        return layout.buffers(self._raw(layout.nbytes))

    @staticmethod
    def _fill(layout: _Layout, bufs, tree):
        leaves, _ = tree_flatten(tree)
        for view, t in zip(layout.leaf_views(bufs), leaves):
            view.copy_(t.detach())

    def _device_buffers(self, layout: _Layout):
        return layout.buffers(torch.empty(layout.nbytes, dtype=torch.uint8, device=self.device))

    def close(self):
        """Unregister the pinned host memory and drop the device slots.  The
        host leaves stay readable (as pageable memory)."""
        self._slots = self._top_dev = None
        for p in getattr(self, "_pinned", ()):
            p.close()
        self._pinned = []
        self._staging = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:                   # at interpreter exit the CUDA runtime may be gone
            pass

    # ---- the reference's interface ---------------------------------------

    def layer(self, i: int):
        """A device copy of layer ``i``'s block parameters (the H2D stream)."""
        bufs = self._device_buffers(self._layout)
        for dt, b in bufs.items():
            b.copy_(self._blocks_host[i][dt])
        return self._layout.views(bufs)

    def top(self):
        """A device copy of the parameters outside the blocks."""
        bufs = self._device_buffers(self._top_layout)
        for dt, b in bufs.items():
            b.copy_(self._top_host[dt])
        return self._top_layout.views(bufs)

    def apply_grad_update(self, i: Optional[int], grads, update_fn):
        """Near-storage optimizer: ``update_fn(w, g)`` updates each host leaf
        ``w`` of layer ``i`` (``None``: the parameters outside the blocks) in
        place from a host copy ``g`` of its gradient, which it may overwrite.
        ``update_fn`` must be elementwise: the stream applies it to slices."""
        layout, bufs = ((self._top_layout, self._top_host) if i is None
                        else (self._layout, self._blocks_host[i]))
        leaves, _ = tree_flatten(grads)
        for w, g in zip(layout.leaf_views(bufs), leaves):
            update_fn(w, g.detach().to("cpu", copy=True))

    # ---- what a pass needs on the device ----------------------------------

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _prepare(self, work_bytes: int):
        """Allocate the slots (once), the top's device buffer, the staging
        ring and the copy streams."""
        if self._slots is not None:
            return
        k, why = _choose_slots(self, work_bytes)
        if self._cuda():
            self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
            self._staging = [self._raw(self._chunk_bytes) for _ in range(STAGING_CHUNKS)]
        self._slots = [self._device_buffers(self._layout) for _ in range(k)]
        self._top_dev = self._device_buffers(self._top_layout)
        self._slot_choice = (k, why)
        if self._staging is None:
            self._staging = [torch.empty(self._chunk_bytes, dtype=torch.uint8)
                             for _ in range(STAGING_CHUNKS)]


def _choose_slots(hp: HostParams, work_bytes: int) -> Tuple[int, str]:
    """The ring's size and why: two slots when two layers, one layer's
    gradient, the top and its gradient and ``work_bytes`` fit the card's
    free memory, else one; two on the CPU."""
    if not hp._cuda():
        return 2, "the CPU: two slots"
    layer, top = hp._layout.nbytes, hp._top_layout.nbytes
    free, _ = torch.cuda.mem_get_info(hp.device)
    free += torch.cuda.memory_reserved(hp.device) - torch.cuda.memory_allocated(hp.device)
    need = 3 * layer + 2 * top + work_bytes
    if need <= free:
        return 2, (f"two slots: 2 x {layer} B of layers + {layer} B of gradient + {2 * top} B "
                   f"of top + {work_bytes} B of working set = {need} B <= {free} B free")
    return 1, (f"one slot, no overlap: two would need {need} B (2 x {layer} + {layer} of "
               f"gradient + top + {work_bytes} of working set), {free} B free")


# --------------------------------------------------------------------------
# the update
# --------------------------------------------------------------------------

def sgd_update(lr: float) -> Callable[[torch.Tensor, torch.Tensor], None]:
    """The reference's near-storage SGD, ``(w - lr * g).astype(w.dtype)`` of
    numpy arrays, bit for bit, in place on ``w`` (``g`` is overwritten).
    numpy multiplies a float32 array, or an ``ml_dtypes`` bfloat16 one (the
    product is float32), by ``lr`` rounded to float32 and subtracts in
    float32: so an fp32 leaf is ``w - f32(lr) * g`` and a bf16 leaf
    ``bf16(f32(w) - f32(lr) * f32(g))``, the product rounded on its own."""
    def update(w: torch.Tensor, g: torch.Tensor):
        if w.dtype not in (torch.float32, torch.bfloat16) or g.dtype != w.dtype:
            raise ValueError(f"sgd_update holds the reference's rounding for fp32 and bf16 "
                             f"leaves, not {w.dtype} (gradient {g.dtype})")
        w, g = w.reshape(-1), g.reshape(-1)
        for a in range(0, w.numel(), UPDATE_ELEMENTS):
            wa, ga = w[a:a + UPDATE_ELEMENTS], g[a:a + UPDATE_ELEMENTS]
            # bf16: the fp32 product; the bf16 - fp32 difference is taken in
            # fp32 and rounded once into w
            wa.sub_((ga if w.dtype == torch.float32 else ga.float()).mul_(lr))
    return update


# --------------------------------------------------------------------------
# one streamed pass: slots, copies, timers, the gradient worker
# --------------------------------------------------------------------------

class _Job:
    def __init__(self, key, layout, tensors, ready, consume):
        self.key, self.layout, self.tensors = key, layout, tensors
        self.ready, self.consume = ready, consume
        self.copied = threading.Event()      # the gradient has left the device


class _Pass:
    """The copy engines' side of one pass: which slot holds which layer,
    the events that order copies and blocks, the timers, and the worker
    thread that streams gradients out and consumes them."""

    def __init__(self, hp: HostParams, work_bytes: int):
        hp._prepare(work_bytes)
        self.hp, self.cuda = hp, hp._cuda()
        k = len(hp._slots)
        self.holds: List[Optional[int]] = [None] * k
        self.ready: List[Any] = [None] * k
        self.freed: List[Any] = [None] * k
        self.lru = list(range(k))
        self.h2d_t: List[Any] = []
        self.d2h_t: List[Any] = []
        self.busy_t: List[Any] = []
        self.busy_host = 0.0
        self.h2d_bytes = self.d2h_bytes = self.h2d_layers = 0
        self.update_s = 0.0
        self.top_views = None
        self.error: Optional[BaseException] = None
        self.jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self.last: Optional[_Job] = None
        self.worker: Optional[threading.Thread] = None
        if self.cuda:
            self.compute = torch.cuda.current_stream(hp.device)
            self.h2d, self.d2h = hp._streams
        self.t0 = time.perf_counter()

    # ---- host to device ---------------------------------------------------

    def _timer(self):
        return torch.cuda.Event(enable_timing=True)

    def _copy_in(self, dst, src, what):
        """Copy host buffers ``src`` into device buffers ``dst`` on the copy
        stream; returns the event that marks the copy done."""
        if not self.cuda:
            for dt, d in dst.items():
                d.copy_(src[dt])
            self.h2d_bytes += sum(d.numel() * d.element_size() for d in dst.values())
            return None
        start, end = self._timer(), self._timer()
        with torch.cuda.stream(self.h2d):
            start.record()
            for dt, d in dst.items():
                _require_pinned(src[dt], what)
                d.copy_(src[dt], non_blocking=True)
            end.record()
        self.h2d_t.append((start, end))
        self.h2d_bytes += sum(d.numel() * d.element_size() for d in dst.values())
        return end

    def top(self):
        """The top's device views; its H2D once a pass."""
        if self.top_views is None:
            done = self._copy_in(self.hp._top_dev, self.hp._top_host, "the top's host buffer")
            if done is not None:
                self.compute.wait_event(done)
            self.top_views = self.hp._top_layout.views(self.hp._top_dev)
        return self.top_views

    def prefetch(self, layer: int):
        """Start layer ``layer``'s H2D into the least recently used slot,
        unless a slot holds it already."""
        if layer in self.holds:
            return
        s = self.lru[0]
        if self.cuda and self.freed[s] is not None:
            self.h2d.wait_event(self.freed[s])     # no block reads the slot any more
        self.holds[s] = layer
        self.h2d_layers += 1
        self.ready[s] = self._copy_in(self.hp._slots[s], self.hp._blocks_host[layer],
                                      f"layer {layer}'s host buffer")

    def get(self, layer: int):
        """Layer ``layer``'s device views, ordered after its copy."""
        self.prefetch(layer)
        s = self.holds.index(layer)
        self.lru.remove(s)
        self.lru.append(s)
        if self.cuda and self.ready[s] is not None:
            self.compute.wait_event(self.ready[s])
        return self.hp._layout.views(self.hp._slots[s])

    def release(self, layer: int):
        """The blocks are done reading ``layer``'s slot (as far as the
        compute stream has been told)."""
        s = self.holds.index(layer)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(self.compute)
            self.freed[s] = ev

    @contextlib.contextmanager
    def busy(self):
        """Time the compute enclosed (device events on a CUDA device)."""
        if not self.cuda:
            t = time.perf_counter()
            yield
            self.busy_host += time.perf_counter() - t
            return
        start, end = self._timer(), self._timer()
        start.record(self.compute)
        yield
        end.record(self.compute)
        self.busy_t.append((start, end))

    # ---- device to host: the worker -----------------------------------------

    def gate(self):
        """Wait until the last gradient handed to the worker has left the
        device: at most one layer's gradient is on the card besides the one
        being computed."""
        if self.last is not None:
            self.last.copied.wait()
        if self.error is not None:
            raise self.error

    def drain(self, key, layout: _Layout, tensors: List[torch.Tensor], consume):
        """Hand ``tensors`` (the leaves of ``layout``, on the device) to the
        worker, which copies them out chunk by chunk and calls
        ``consume(key, dtype, a, b, host_chunk)`` on each."""
        if self.worker is None:
            self.worker = threading.Thread(target=self._work, name="stream-drain", daemon=True)
            self.worker.start()
        ready = None
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record(self.compute)
        self.last = _Job(key, layout, [t.contiguous() for t in tensors], ready, consume)
        self.jobs.put(self.last)

    def _work(self):
        ctx = torch.cuda.device(self.hp.device) if self.cuda else contextlib.nullcontext()
        with ctx:
            while True:
                job = self.jobs.get()
                if job is None:
                    return
                try:
                    if self.error is None:
                        self._run(job)
                except Exception as e:          # raised again on the main thread
                    self.error = e
                finally:
                    job.tensors = None
                    job.copied.set()

    def _run(self, job: _Job):
        staging = self.hp._staging
        flats = [t.reshape(-1) for t in job.tensors]
        if self.cuda:
            self.d2h.wait_event(job.ready)
        in_flight: deque = deque()
        chunks = job.layout.chunks(self.hp._chunk_bytes)
        for c, (dt, a, b, pieces) in enumerate(chunks):
            if len(in_flight) == len(staging):
                self._consume(job, *in_flight.popleft())
            host = staging[c % len(staging)][:(b - a) * dt.itemsize].view(dt)
            end = self._copy_out(host, [(flats[i][lo:hi]) for i, lo, hi in pieces])
            in_flight.append((dt, a, b, host, end))
        if self.cuda and in_flight:
            in_flight[-1][-1].synchronize()
        job.tensors = flats = None              # the device may reuse the memory
        job.copied.set()
        while in_flight:
            self._consume(job, *in_flight.popleft())

    def _copy_out(self, host: torch.Tensor, parts: List[torch.Tensor]):
        n = 0
        if not self.cuda:
            for p in parts:
                host[n:n + p.numel()].copy_(p)
                n += p.numel()
            self.d2h_bytes += host.numel() * host.element_size()
            return None
        _require_pinned(host, "a staging chunk")
        start, end = self._timer(), self._timer()
        with torch.cuda.stream(self.d2h):
            start.record()
            for p in parts:
                host[n:n + p.numel()].copy_(p, non_blocking=True)
                n += p.numel()
            end.record()
        self.d2h_t.append((start, end))
        self.d2h_bytes += host.numel() * host.element_size()
        return end

    def _consume(self, job, dt, a, b, host, end):
        if end is not None:
            end.synchronize()                   # the chunk has landed on the host
        t = time.perf_counter()
        job.consume(job.key, dt, a, b, host)
        self.update_s += time.perf_counter() - t

    # ---- the end of the pass ------------------------------------------------

    def stop(self):
        """Let the worker finish what it was handed, and end it."""
        if self.worker is not None:
            self.jobs.put(None)
            self.worker.join()
            self.worker = None

    def finish(self, **extra):
        """Wait for the worker and the device; fill ``hp.stats``."""
        self.stop()
        if self.cuda:
            torch.cuda.synchronize(self.hp.device)
        wall = time.perf_counter() - self.t0
        if self.error is not None:
            raise self.error

        def total(pairs):
            return sum(s.elapsed_time(e) for s, e in pairs) / 1e3
        h2d_s, d2h_s = total(self.h2d_t), total(self.d2h_t)
        device_s = total(self.busy_t) if self.cuda else self.busy_host
        k, why = self.hp._slot_choice
        self.hp.stats = {
            "wall_s": wall, "h2d_bytes": self.h2d_bytes, "h2d_s": h2d_s,
            "d2h_bytes": self.d2h_bytes, "d2h_s": d2h_s, "update_s": self.update_s,
            "threads": torch.get_num_threads(), "device_s": device_s,
            "overlap": ((h2d_s + device_s - wall) / min(h2d_s, device_s)
                        if min(h2d_s, device_s) > 0 else None),
            "h2d_layers": self.h2d_layers, "slots": k, "slots_why": why,
            "pinned_bytes": self.hp.pinned_bytes, **extra}


# --------------------------------------------------------------------------
# the streamed model
# --------------------------------------------------------------------------

def _require_streamable(cfg: ModelConfig, batch, tp, ep, mesh):
    tfm._require_ported(cfg)
    if tp is not None or ep is not None or mesh is not None:
        raise ValueError("weight streaming runs on one device, as the reference's does: "
                         "tp=, ep= and mesh= are not taken")
    if cfg.family == "hybrid":
        raise ValueError(f"{cfg.name} is a hybrid: the reference streams its Mamba2 blocks and "
                         f"skips the shared attention block, so its loss is not loss_fn's; "
                         f"the port does not stream it")
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name} is an encoder/decoder: the stream embeds tokens only and "
                         f"has no encoder to cross-attend to")
    if cfg.family == "vlm" and "patch_embeds" in batch:
        raise ValueError(f"{cfg.name}: the stream embeds tokens only; a batch with "
                         f"patch_embeds is not streamed (a tokens-only batch is)")


def _block_fn(cfg: ModelConfig, pcfg: ParallelConfig, positions):
    """One decoder block as a function of (block params, x) -> (y, aux), as
    ``loss_fn`` runs it (aux: the MoE router's loss, else None)."""
    if cfg.family == "ssm":
        def f(bp, x):
            return x + mamba2_forward(bp["ssm"], rms_norm(x, bp["ln"], cfg.norm_eps), cfg), None
    else:
        def f(bp, x):
            out = apply_attn_block(bp, cfg, pcfg, x, positions=positions, mode="train")
            return out[0], out[3]
    return f


def _head_loss(top, x, labels, cfg):
    x = rms_norm(x, top["final_norm"], cfg.norm_eps)
    head = top["embed"].T if cfg.tie_embeddings else top["lm_head"]
    loss, _ = softmax_cross_entropy(x @ head, labels, cfg.vocab_size)
    return loss


def _work_bytes(hp: HostParams, cfg, B: int, S: int) -> int:
    """Device bytes a pass needs besides the slots: the L+1 boundary
    activations, the head's logits and their gradient, and a block's
    working set (``WORK_RESERVE_BYTES``)."""
    item = max(dt.itemsize for dt in hp._layout.sizes)
    acts = (hp.n_layers + 1) * B * S * cfg.d_model * item
    return acts + 3 * B * S * cfg.padded_vocab * item + WORK_RESERVE_BYTES


def _inputs(hp: HostParams, batch):
    tokens = torch.as_tensor(batch["tokens"]).to(hp.device)
    labels = torch.as_tensor(batch["labels"]).to(hp.device)
    return tokens, labels


def _forward(run: _Pass, tokens, labels, cfg, pcfg):
    """The streamed forward under ``no_grad``: returns (total, loss, aux,
    the L+1 boundary activations on the device)."""
    hp = run.hp
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=hp.device)[None].expand(B, S)
    block = _block_fn(cfg, pcfg, positions)
    with torch.no_grad():
        top = run.top()
        with run.busy():
            x = top["embed"][tokens]
        acts = [x]
        aux = torch.zeros((), dtype=torch.float32, device=hp.device)
        for l in range(hp.n_layers):
            bp = run.get(l)
            if len(hp._slots) > 1 and l + 1 < hp.n_layers:
                run.prefetch(l + 1)                # overlaps this block
            with run.busy():
                x, a = block(bp, x)
                if a is not None:
                    aux = aux + a
            run.release(l)
            acts.append(x)
        with run.busy():
            loss = _head_loss(top, x, labels, cfg)
            total = loss + cfg.router_aux_weight * aux
    return total, loss, aux, acts


def _backward(run: _Pass, tokens, labels, cfg, pcfg, acts, consume):
    """The streamed backward: the head, then each layer in reverse (fetched
    again, recomputed, its gradient handed to the worker with ``consume``),
    then the embedding lookup's gradient added to the top's, which goes
    last."""
    hp = run.hp
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=hp.device)[None].expand(B, S)
    block = _block_fn(cfg, pcfg, positions)
    top_layout = hp._top_layout
    run.top()
    top_leaves = [t.detach().requires_grad_() for t in top_layout.leaf_views(hp._top_dev)]
    top_tree = tree_unflatten(top_layout.spec, top_leaves)
    embed_i = next(i for i, t in enumerate(top_leaves) if t is top_tree["embed"])
    with run.busy(), torch.enable_grad():
        x_last = acts[-1].detach().requires_grad_()
        loss = _head_loss(top_tree, x_last, labels, cfg)
        g = torch.autograd.grad(loss, top_leaves + [x_last], allow_unused=True)
    g_top = [torch.zeros_like(t) if gt is None else gt for t, gt in zip(top_leaves, g[:-1])]
    g_x = g[-1]
    acts[-1] = x_last = loss = g = None
    aux_w = torch.tensor(cfg.router_aux_weight, dtype=torch.float32, device=hp.device)
    for l in reversed(range(hp.n_layers)):
        bp = run.get(l)
        if len(hp._slots) > 1 and l > 0:
            run.prefetch(l - 1)                    # overlaps this recompute and backward
        leaves = [t.detach().requires_grad_() for t in tree_flatten(bp)[0]]
        with torch.enable_grad():
            x_in = acts[l].detach().requires_grad_()
            with run.busy():
                y, a = block(tree_unflatten(hp._layout.spec, leaves), x_in)
            outs, couts = [y], [g_x]
            if a is not None and a.requires_grad and cfg.router_aux_weight:
                outs.append(a)
                couts.append(aux_w)
            run.gate()                             # the last layer's gradient has left
            with run.busy():
                gs = torch.autograd.grad(outs, leaves + [x_in], couts, allow_unused=True)
        run.release(l)
        acts[l + 1] = y = a = outs = x_in = None
        g_x = gs[-1]
        run.drain(l, hp._layout, [torch.zeros_like(t) if gl is None else gl
                                  for t, gl in zip(leaves, gs[:-1])], consume)
        leaves = gs = None
    with run.busy(), torch.enable_grad():
        emb = top_leaves[embed_i].detach().requires_grad_()
        (g_emb,) = torch.autograd.grad(emb[tokens], emb, g_x)
        g_top[embed_i] = g_top[embed_i] + g_emb
    acts[0] = None
    run.drain(None, top_layout, g_top, consume)


def _open(hp: HostParams, batch, cfg, tp, ep, mesh):
    _require_streamable(cfg, batch, tp, ep, mesh)
    tokens, labels = _inputs(hp, batch)
    B, S = tokens.shape
    return _Pass(hp, _work_bytes(hp, cfg, B, S)), tokens, labels


def stream_forward(hp: HostParams, batch, cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
                   *, tp=None, ep=None, mesh=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Layer-streaming forward: returns (total, the L+1 boundary activations
    on the device).  ``total`` is ``loss_fn``'s: the cross-entropy plus, for
    MoE, ``router_aux_weight`` times the blocks' summed aux loss."""
    pcfg = pcfg or ParallelConfig()
    run, tokens, labels = _open(hp, batch, cfg, tp, ep, mesh)
    try:
        total, loss, aux, acts = _forward(run, tokens, labels, cfg, pcfg)
        run.finish(loss=float(loss), aux_loss=float(aux))
    finally:
        run.stop()
    return total, acts


def stream_grads(hp: HostParams, batch, cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
                 *, tp=None, ep=None, mesh=None):
    """Streaming backward: gradients computed layer by layer and streamed to
    the host.  Returns (total, the gradient of the parameters outside the
    blocks, one gradient tree a layer), the gradients host tensors.  Every
    layer's weights cross the link a second time for the backward, the
    paper's "model loaded at least twice per iteration"."""
    pcfg = pcfg or ParallelConfig()
    run, tokens, labels = _open(hp, batch, cfg, tp, ep, mesh)
    out = {None: hp._top_layout.buffers(torch.empty(hp._top_layout.nbytes, dtype=torch.uint8))}
    for l in range(hp.n_layers):
        out[l] = hp._layout.buffers(torch.empty(hp._layout.nbytes, dtype=torch.uint8))

    def keep(key, dt, a, b, chunk):
        out[key][dt][a:b].copy_(chunk)
    try:
        total, loss, aux, acts = _forward(run, tokens, labels, cfg, pcfg)
        _backward(run, tokens, labels, cfg, pcfg, acts, keep)
        run.finish(loss=float(loss), aux_loss=float(aux))
    finally:
        run.stop()
    return (total, hp._top_layout.views(out[None]),
            [hp._layout.views(out[l]) for l in range(hp.n_layers)])


def stream_train_step(hp: HostParams, batch, cfg: ModelConfig,
                      pcfg: Optional[ParallelConfig] = None, lr: float = 1e-3,
                      *, tp=None, ep=None, mesh=None) -> float:
    """One weight-streaming SGD step with the near-storage update: each
    layer's host weights are updated (``sgd_update(lr)``) as its gradient
    lands, the parameters outside the blocks last.  Returns the total."""
    pcfg = pcfg or ParallelConfig()
    run, tokens, labels = _open(hp, batch, cfg, tp, ep, mesh)
    update = sgd_update(lr)

    def apply(key, dt, a, b, chunk):
        bufs = hp._top_host if key is None else hp._blocks_host[key]
        update(bufs[dt][a:b], chunk)
    try:
        total, loss, aux, acts = _forward(run, tokens, labels, cfg, pcfg)
        _backward(run, tokens, labels, cfg, pcfg, acts, apply)
        run.finish(loss=float(loss), aux_loss=float(aux))
    finally:
        run.stop()
    return float(total)
