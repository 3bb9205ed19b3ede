"""Shared model building blocks (counterpart of
``repro/models/common.py``): the normal initializer, norms, rotary
embeddings, and the distribution context every layer takes."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DistCtx:
    """The distribution context of the reference's signatures: ``mesh``
    None runs on one device; under a ``utils.mesh.Mesh`` each rank holds
    its parts of the parameters as ``launch/sharding.param_spec`` lays
    them out (FSDP over the ``dp`` axes, tensor parallelism over ``tp``,
    the MoE layers' experts as ``models/moe.py`` cuts them) and runs on
    its rows of the batch where the batch divides over ``dp``
    (``batch_cut``: the activations' leading dim holds this rank's rows
    of the global batch, ``launch/sharding.cut_batch``); where it does
    not, every rank runs on the whole batch. ``dp`` names the
    data-parallel axes, ``tp`` the tensor / expert-parallel axis.
    ``cache_room``: the whole sequence length of a decode step's full
    and latent caches (the room the cache was made with), which a rank
    holding a block of them (the context-parallel cache,
    ``launch/sharding.seq_block``) cannot read off its part;
    ``Model.serve_step`` sets it."""
    mesh: Optional[object] = None
    dp: Tuple[str, ...] = ("data",)
    tp: str = "model"
    batch_cut: bool = False
    cache_room: Optional[int] = None

    @staticmethod
    def local() -> "DistCtx":
        return DistCtx()

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.tp]

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.dp)

    def partial_axes(self, tp: bool = False) -> Tuple[str, ...]:
        """The axes over which a value's cotangent is a partial sum when
        it feeds work that differs by rank: the ``dp`` axes where the
        batch is cut, and ``tp`` where the work is tensor-parallel."""
        out = tuple(self.dp) if self.batch_cut else ()
        return out + ((self.tp,) if tp else ())


def tp_heads(ctx: Optional[DistCtx], H: int):
    """This rank's heads [h0, h1) of H (attention heads, an RWKV-6 or
    Mamba2 layer's state heads, an FFN's hidden columns) where the work
    runs tensor-parallel under ``ctx`` (``tp`` > 1 and H dividing over
    it), else None (every rank runs every head)."""
    if ctx is None or ctx.mesh is None:
        return None
    tp = ctx.tp_size
    if tp == 1 or H % tp:
        return None
    n = H // tp
    r = ctx.mesh.index((ctx.tp,))
    return r * n, (r + 1) * n


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts, tuples and lists of
    tensors (a model's parameters or its cache), in the same nesting."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


@dataclass(frozen=True)
class Part:
    """This rank's part of a sharded leaf: rows ``lo:hi`` of dim ``axis``
    (negative, counted from the last, so that a layer's leaf and its
    layer-stacked segment leaf share one part), cut over the mesh axes
    ``axes`` in shard order. Rows past the leaf's extent are zeros (the
    padded experts of ``models/moe.py``)."""
    axis: int
    lo: int
    hi: int
    axes: Tuple[str, ...]

    def shape(self, full: Sequence[int]) -> Tuple[int, ...]:
        out = list(full)
        out[self.axis] = self.hi - self.lo
        return tuple(out)

    def take(self, w):
        """This part of ``w`` (a tensor or a numpy array holding the
        whole leaf), as a copy that keeps nothing else of ``w`` alive."""
        ext = w.shape[self.axis]
        idx = [slice(None)] * w.ndim
        idx[self.axis] = slice(min(self.lo, ext), min(self.hi, ext))
        got = w[tuple(idx)]
        pad = list(got.shape)
        pad[self.axis] = self.hi - self.lo - got.shape[self.axis]
        if isinstance(w, torch.Tensor):
            if pad[self.axis] == 0:
                return got.clone()
            return torch.cat([got, got.new_zeros(pad)], dim=self.axis)
        if pad[self.axis] == 0:
            return got.copy()
        return np.concatenate([got, np.zeros(pad, got.dtype)],
                              axis=self.axis)


def as_parts(part) -> Tuple["Part", ...]:
    """A leaf's layout as a tuple of :class:`Part` s, one a cut dim
    (``part``: None, one Part or a tuple of them)."""
    if part is None:
        return ()
    return (part,) if isinstance(part, Part) else tuple(part)


def parts_shape(parts, full: Sequence[int]) -> Tuple[int, ...]:
    """The shape this rank holds of a leaf of shape ``full``."""
    out = tuple(full)
    for p in as_parts(parts):
        out = p.shape(out)
    return out


def take_parts(parts, w):
    """This rank's parts of ``w`` (the whole leaf), cut on every dim of
    ``parts`` (a copy; ``w`` itself where nothing is cut)."""
    for p in as_parts(parts):
        w = p.take(w)
    return w


def relay(w: torch.Tensor, have, need, mesh, partial=(),
          extent: Optional[Dict[int, int]] = None) -> torch.Tensor:
    """``w``, held as the parts ``have``, in the layout ``need`` (each a
    tuple of :class:`Part` s; a cut over one rank counts as whole):
    every held cut that ``need`` lacks is gathered over its axes (and,
    where ``extent`` gives its dim's size, trimmed of padding), every
    cut that ``need`` adds is taken.

    ``partial``: the mesh axes over which the work ``w`` feeds differs by
    rank, so that its cotangent there is a partial sum. The backward
    sums it over those axes: for a gathered cut by a reduce-scatter onto
    the part held, for the axes the leaf is replicated on by a psum
    (``ShardGroup.psum_grad``); over the other axes the cotangent is
    replicated, and a gather takes this rank's rows of it. Without a
    mesh ``w`` itself."""
    if mesh is None:
        return w
    have = tuple(p for p in as_parts(have) if mesh.size(p.axes) > 1)
    need = tuple(p for p in as_parts(need) if mesh.size(p.axes) > 1)
    held = {a for p in have for a in p.axes}
    rep = tuple(a for a in mesh.axis_names if a in partial and a not in held)
    w = mesh.group(rep).psum_grad(w)
    for p in have:
        if p in need:
            continue
        axes = tuple(p.axes)
        grad = ("reduce_scatter" if all(a in partial for a in axes)
                else "rows")
        w = mesh.group(axes).all_gather(w, dim=p.axis, grad=grad)
        some = tuple(a for a in axes if a in partial)
        if some and grad == "rows":
            w = mesh.group(some).psum_grad(w)
        if extent and p.axis in extent:
            w = w.narrow(p.axis, 0, extent[p.axis])
    for p in need:
        if p not in have:
            w = p.take(w)
    return w


def enter_region(x: torch.Tensor, ctx: Optional[DistCtx], *, seq: bool,
                 local: bool, dim: int = 1) -> torch.Tensor:
    """The residual stream ``x`` as it enters a block's work: where
    ``seq`` it is cut on dim ``dim`` over ``tp`` and is all-gathered
    (the sequence-parallel layout), else it is replicated over ``tp``.
    ``local``: the work is tensor-parallel (its cotangent differs by
    rank), so the backward sums the cotangent over ``tp``
    (reduce-scattered back to this rank's rows where ``seq``); otherwise
    the work is the same on every rank and the backward takes this
    rank's rows of it."""
    if ctx is None or ctx.mesh is None:
        return x
    g = ctx.mesh.group(ctx.tp)
    if seq:
        return g.all_gather(x, dim=dim,
                            grad="reduce_scatter" if local else "rows")
    return g.psum_grad(x) if local else x


def leave_region(y: torch.Tensor, ctx: Optional[DistCtx], *, seq: bool,
                 local: bool, dim: int = 1) -> torch.Tensor:
    """A block's result back into the residual's layout: a
    tensor-parallel (``local``) partial product summed over ``tp``
    (reduce-scattered on dim ``dim`` where ``seq``, psummed otherwise);
    a result the same on every rank cut to this rank's rows where
    ``seq``."""
    if ctx is None or ctx.mesh is None:
        return y
    g = ctx.mesh.group(ctx.tp)
    if seq:
        return (g.reduce_scatter(y, dim=dim) if local
                else g.shard_rows(y, dim=dim))
    return g.psum(y) if local else y


class ShapeOnly:
    """A stand-in for a generator: :func:`dense_init` and the other
    initializers make tensors on the ``meta`` device (shapes and dtypes,
    no data): ``Model.param_shapes``."""
    device = torch.device("meta")


# A tensor of more elements than DRAW_WHOLE is drawn in pieces of at
# most DRAW_PIECE elements along its first axis (DeepSeek-V3's stacked
# experts, 3.8e9 elements, would take 15 GB in f32 at once).
DRAW_WHOLE, DRAW_PIECE = 1 << 30, 1 << 28


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: float = 0.02, part=None) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` drawn in f32 from ``gen`` on the
    generator's device, stored in ``dtype``: a CPU generator draws on
    the CPU, a CUDA generator on the card (the full-width models have
    billions of parameters). Above ``DRAW_WHOLE`` elements the draw
    goes piece by piece into the stored tensor. With ``part`` (a
    :class:`Part` or a tuple of them, one a cut dim) only that part of
    the draw is kept, cut from each piece as it is drawn: the generator
    advances as for the whole tensor, so the part holds the bits of the
    same part of an uncut draw."""
    shape = tuple(shape)
    parts = as_parts(part)
    if gen.device.type == "meta":
        return torch.empty(parts_shape(parts, shape), dtype=dtype,
                           device=gen.device)
    n = math.prod(shape)
    if n <= DRAW_WHOLE:
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (take_parts(parts, w) * scale).to(dtype)
    rows = max(1, DRAW_PIECE // (n // shape[0]))
    first = [p for p in parts if p.axis % len(shape) == 0]
    rest = tuple(p for p in parts if p.axis % len(shape) != 0)
    if not parts:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
    else:
        out = torch.zeros(parts_shape(parts, shape), dtype=dtype,
                          device=gen.device)
    lo0, hi0 = (first[0].lo, first[0].hi) if first else (0, shape[0])
    for lo in range(0, shape[0], rows):
        hi = min(lo + rows, shape[0])
        w = torch.randn((hi - lo,) + shape[1:], generator=gen,
                        dtype=torch.float32, device=gen.device)
        w = (w * scale).to(dtype)
        a, b = max(lo, lo0), min(hi, hi0)     # the rows the part keeps
        if a < b:
            out[a - lo0:b - lo0].copy_(take_parts(rest, w[a - lo:b - lo]))
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``(xf * rsqrt(mean(xf^2) + eps)).to(x.dtype) * w`` with xf the
    f32 copy of x: the reference's cast order."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalized in f32 (population variance), cast back, then
    ``* w + b`` in x's dtype: the reference's cast order."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, params["w"], params["b"])
    return rms_norm(x, params["w"])


def init_norm(kind: str, d: int, dtype,
              device=None) -> Dict[str, torch.Tensor]:
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """(hd / 2,) f32 inverse frequencies ``1 / theta^(2i / hd)``."""
    i = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated in halves (the first D/2 features
    against the last); positions broadcastable to x.shape[:-2] + (S,).
    In f32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood over the valid tokens:
    logits (..., V) upcast to f32, labels (...) in [0, V), mask (...)
    bool or None; the sum over the mask divided by max(sum(mask), 1)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def masked_mean(nll: torch.Tensor, mask: torch.Tensor,
                ctx: Optional[DistCtx] = None) -> torch.Tensor:
    """:func:`cross_entropy`'s mean of per-token values ``nll`` over the
    bool ``mask``: the sum over the mask divided by max(count, 1); where
    ``ctx.batch_cut`` both sums are over the global batch (psummed over
    ``dp``, in shard order: the same bits on every rank)."""
    m = mask.float()
    num, den = torch.sum(nll * m), torch.sum(m)
    if ctx is not None and ctx.mesh is not None and ctx.batch_cut:
        g = ctx.mesh.group(ctx.dp)
        num, den = g.psum(num.reshape(1))[0], g.psum(den.reshape(1))[0]
    return num / torch.clamp_min(den, 1.0)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                       group) -> torch.Tensor:
    """Per-token negative log-likelihood of logits cut on the vocab over
    ``group`` (a ``utils.mesh.ShardGroup``): ``logits`` (..., V_loc)
    holds vocab ids lo:lo + V_loc, ``labels`` (...) are global ids. In
    f32: the max over the group (detached: a shift the result does not
    depend on), the sum over the group of exp(logit - max), and the
    label's logit from the rank that holds it (zeros elsewhere) summed
    over the group; every sum in shard order, so the result is the same
    bits on every rank. The backward passes the cotangent of those sums
    through to each rank's columns (Megatron's vocab-parallel
    cross-entropy)."""
    lf = logits.float()
    top = group.pmax(torch.amax(lf.detach(), dim=-1))
    se = group.psum(torch.sum(torch.exp(lf - top[..., None]), dim=-1))
    lse = top + torch.log(se)
    ids = labels.long() - lo
    mine = (ids >= 0) & (ids < lf.shape[-1])
    gold = torch.gather(lf, -1, torch.where(mine, ids, 0)[..., None])[..., 0]
    gold = group.psum(torch.where(mine, gold, torch.zeros_like(gold)))
    return lse - gold
