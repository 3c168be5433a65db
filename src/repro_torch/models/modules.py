"""Minimal module substrate of the port: plain functions on tensors.

Counterpart of ``repro.models.modules``.  Parameters are nested dictionaries
of ``torch.Tensor`` with the JAX package's names (``embed``, ``final_norm``,
``blocks.{ln1, attn.{wq, wk, wv, wo, bq, bk, bv, q_norm, k_norm}, ln2,
ffn.{w_gate, w_up, w_down}}``), so a value tree of one package converts to
the other leaf by leaf (``repro_torch.convert``).  The JAX package boxes each
value with its logical axis names (``Box`` / ``AxisNames``, then ``split``);
here the names live in a tree of their own beside the values, each leaf a
tuple of names: every ``init_*`` has an ``*_axes`` sibling, and
``transformer.param_axes(cfg)`` gives the whole tree (what ``split(init(...))
[1]`` gives in the JAX package), which ``parallel.sharding.Ruleset`` turns into
placements.  ``stack_axes`` prepends the ``layers`` name to every leaf, as
``AxisNames.stacked`` does.

Initialisers draw from an explicit ``torch.Generator`` that lives on the
target device; they never touch the global generator.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """Apply ``fn`` to every tensor of a parameter tree (nested dicts and
    lists, as ``transformer.init`` returns)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _flatten_into(t, leaves: List[Any], is_leaf: Callable[[Any], bool]):
    if t is None:
        return None
    if is_leaf(t):
        leaves.append(t)
        return "*"
    if isinstance(t, dict):
        return (dict, tuple((k, _flatten_into(t[k], leaves, is_leaf)) for k in sorted(t)))
    if isinstance(t, (list, tuple)):
        return (type(t), tuple(_flatten_into(x, leaves, is_leaf) for x in t))
    leaves.append(t)
    return "*"


def tree_flatten(tree, is_leaf: Callable[[Any], bool] = lambda _: False
                 ) -> Tuple[List[Any], Any]:
    """Leaves of a tree of dicts, lists, tuples and named tuples, in the
    order ``jax.tree.flatten`` takes them (dict keys sorted; ``None`` is an
    empty subtree), and a spec that ``tree_unflatten`` rebuilds it from.
    ``is_leaf`` stops the walk at a node (e.g. a quantised moment).

    The walks here and in ``tree_unflatten`` are module functions, not
    closures that call themselves: such a closure is a reference cycle (the
    function, its cell), and one that holds the leaves keeps every tensor of
    the tree alive until the garbage collector runs."""
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves, is_leaf)


def _build(sp, it):
    if sp is None:
        return None
    if sp == "*":
        return next(it)
    kind, children = sp
    if kind is dict:
        return {k: _build(c, it) for k, c in children}
    items = [_build(c, it) for c in children]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def tree_unflatten(spec, leaves: Sequence[Any]):
    """Inverse of ``tree_flatten``."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def stack_axes(tree, name: str = "layers"):
    """A tree of axis-name tuples with ``name`` prepended to every leaf: the
    axes of a stack of layers on a leading dimension (the JAX layout)."""
    if isinstance(tree, dict):
        return {k: stack_axes(v, name) for k, v in tree.items()}
    return (name,) + tuple(tree)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA request without CUDA raises.

    Entry points default to ``"cuda"``: the CPU is used only when the caller
    asks for it by name.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, the usual transformer default."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) <= 2 else int(math.prod(shape[:-1]))
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (w * std).to(dtype)


def zeros_init(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# core ops
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation (returns x.dtype)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation, which is what jax.nn.gelu computes by default
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)


NEG_BIG = -3e38  # near-min float32; representable in bf16 too

# rows of the (N, V) logits taken at a time, so that the fp32 copy of a chunk
# stays near 256 MB whatever the vocabulary
_CE_CHUNK_ELEMENTS = 1 << 26


class _CrossEntropy(torch.autograd.Function):
    """Mean token cross-entropy with its gradient written out, chunk by chunk
    of rows, so that no fp32 (B, S, V) tensor exists at any time: the forward
    saves the logits as they are (their dtype) and the per-row log-sum-exp,
    and the backward writes the gradient in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_size: int, z_weight: float):
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        lab = labels.reshape(-1).long()
        lse = torch.empty(flat.shape[0], dtype=torch.float32, device=logits.device)
        rows = max(1, _CE_CHUNK_ELEMENTS // v)
        for r0 in range(0, flat.shape[0], rows):
            # a copy also in fp32: the padded columns are written below
            x = flat[r0:r0 + rows].to(torch.float32, copy=True)
            if vocab_size < v:                 # padded vocab: out of the exp-sum
                x[:, vocab_size:] = NEG_BIG
            m = x.amax(dim=-1)
            lse[r0:r0 + rows] = m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1))
        picked = flat.gather(1, lab.clamp_min(0)[:, None])[:, 0].float()
        nll = lse - picked
        if z_weight:
            nll = nll + z_weight * lse.square()
        mask = (lab >= 0).float()
        count = mask.sum().clamp_min(1.0)
        ctx.save_for_backward(logits, lab, lse, count)
        ctx.vocab_size, ctx.z_weight = vocab_size, z_weight
        ctx.mark_non_differentiable(count)
        return (nll * mask).sum() / count, count

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_loss, _g_count):
        logits, lab, lse, count = ctx.saved_tensors
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        grad = torch.empty_like(flat)
        # d loss / d logit = w * (softmax * (1 + 2 z lse) - onehot(label)),
        # w = g / count on unmasked rows, 0 on masked ones
        w = g_loss.float() * (lab >= 0).float() / count
        rows = max(1, _CE_CHUNK_ELEMENTS // v)
        for r0 in range(0, flat.shape[0], rows):
            x = flat[r0:r0 + rows].to(torch.float32, copy=True)
            if ctx.vocab_size < v:
                x[:, ctx.vocab_size:] = NEG_BIG
            lse_c = lse[r0:r0 + rows, None]
            p = torch.exp(x - lse_c)
            if ctx.z_weight:
                p = p * (1 + 2 * ctx.z_weight * lse_c)
            w_c = w[r0:r0 + rows]
            p = p * w_c[:, None]
            lab_c = lab[r0:r0 + rows].clamp_min(0)[:, None]
            p.scatter_add_(1, lab_c, -w_c[:, None])
            grad[r0:r0 + rows] = p.to(grad.dtype)
        return grad.view_as(logits), None, None, None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int, z_weight: float = 0.0):
    """Token-level CE over a (possibly padded) vocab; labels < 0 are masked.

    Counterpart of ``repro.models.modules.softmax_cross_entropy``: logits
    stay in their dtype; fp32 appears only inside the reductions (max,
    exp-sum, the picked logit), taken over chunks of rows, so no fp32 (B, S, V)
    tensor is materialised; padded vocab entries are set to -3e38 inside each
    fp32 chunk, out of the exp-sum.  The gradient is written out by hand
    (``_CrossEntropy``), chunk by chunk, in the logits' dtype.
    Returns (mean_loss, token_count), both fp32 scalars.
    """
    return _CrossEntropy.apply(logits, labels, vocab_size, float(z_weight))
