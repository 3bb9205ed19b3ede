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
    None runs on one device; a ``utils.mesh.Mesh`` runs every rank on
    the whole batch (replicated activations, as every rank of
    ``core/distributed.py`` runs on the same host inputs), with the MoE
    layer's experts sharded over the mesh (``models/moe.py``). ``dp``
    names the data-parallel axes, ``tp`` the tensor / expert-parallel
    axis."""
    mesh: Optional[object] = None
    dp: Tuple[str, ...] = ("data",)
    tp: str = "model"

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


# A tensor of more elements than DRAW_WHOLE is drawn in pieces of at
# most DRAW_PIECE elements along its first axis (DeepSeek-V3's stacked
# experts, 3.8e9 elements, would take 15 GB in f32 at once).
DRAW_WHOLE, DRAW_PIECE = 1 << 30, 1 << 28


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: float = 0.02, part: Optional[Part] = None
               ) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` drawn in f32 from ``gen`` on the
    generator's device, stored in ``dtype``: a CPU generator draws on
    the CPU, a CUDA generator on the card (the full-width models have
    billions of parameters). Above ``DRAW_WHOLE`` elements the draw
    goes piece by piece into the stored tensor. With ``part`` only that
    :class:`Part` of the draw is kept, cut from each piece as it is
    drawn: the generator advances as for the whole tensor, so the part
    holds the bits of the same part of an uncut draw."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n <= DRAW_WHOLE:
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        if part is not None:
            w = part.take(w)
        return (w * scale).to(dtype)
    rows = max(1, DRAW_PIECE // (n // shape[0]))
    if part is None:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
    else:
        out = torch.zeros(part.shape(shape), dtype=dtype, device=gen.device)
    for lo in range(0, shape[0], rows):
        hi = min(lo + rows, shape[0])
        w = torch.randn((hi - lo,) + shape[1:], generator=gen,
                        dtype=torch.float32, device=gen.device)
        w = (w * scale).to(dtype)
        if part is None:
            out[lo:hi].copy_(w)
        elif part.axis % len(shape) == 0:      # the part cuts the pieces' axis
            a, b = max(lo, part.lo), min(hi, part.hi)
            if a < b:
                out[a - part.lo:b - part.lo].copy_(w[a - lo:b - lo])
        else:
            out[lo:hi].copy_(part.take(w))
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
