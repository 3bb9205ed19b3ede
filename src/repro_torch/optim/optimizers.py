"""Optimizers (counterpart of ``repro/optim/optimizers.py``): sgd,
adamw and adafactor, functional in form, with ``init(params)`` and
``update(grads, state, params, step) -> (params, state)`` over the
reference's state trees (adamw ``{"m", "v"}``; sgd ``{}`` or ``{"m"}``;
adafactor ``{"f": {"r", "c"} | {"v"}}`` per leaf), so that a JAX
optimizer state carries across (``convert.train_state``). The
arithmetic is the reference's: f32 moments (sgd's momentum in the
parameter's dtype), adamw's ``(m / c1) / (sqrt(v / c2) + eps)`` with
``t = step + 1`` in f32, adafactor's ``rsqrt(max(vhat, eps))`` and RMS
clipping, the update applied in f32 and cast back. ``torch.optim.AdamW``
computes another formula and is not used.

Unlike the reference, ``update`` and ``clip_by_global_norm`` write the
new values into the tensors they are given and return them: at full
width a second copy of the parameters and the moments would not fit on
the card. Elementwise updates run over flat slices of at most
``CHUNK`` elements, which bounds their f32 temporaries and leaves every
element's arithmetic as it is.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, NamedTuple, Union

import torch

from repro_torch.utils.tree import leaves, map_sorted

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]

# Elements of a slice of an elementwise update.
CHUNK = 1 << 26


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params, step) -> (params, state)


def _lr_at(lr: Schedule, step) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32,
                        device=torch.as_tensor(step).device)


def _slices(*tensors) -> Iterator[List[torch.Tensor]]:
    """Matching flat slices of same-shaped contiguous tensors (views:
    writing a slice writes the tensor)."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("optimizer: the parameters, gradients and "
                             "moments must be contiguous")
    flats = [t.view(-1) for t in tensors]
    n = flats[0].numel()
    for lo in range(0, n, CHUNK):
        yield [f[lo:lo + CHUNK] for f in flats]


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / max(gn, 1e-9))``, in
    f32 and cast back, in place; gn is the global norm of the leaves'
    f32 squares, added in sorted-key order. Returns (grads, gn)."""
    gs = leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    for g in gs:
        for (piece,) in _slices(g):
            piece.copy_((piece.float() * scale).to(piece.dtype))
    return grads, gn


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": map_sorted(torch.zeros_like, params)}

    def update(grads, state, params, step):
        lrt = _lr_at(lr, step)
        if momentum == 0.0:
            for p, g in zip(leaves(params), leaves(grads)):
                for pp, gg in _slices(p, g):
                    pp.copy_(pp - (lrt * gg.float()).to(pp.dtype))
            return params, state
        for p, g, m in zip(leaves(params), leaves(grads),
                           leaves(state["m"])):
            for pp, gg, mm in _slices(p, g, m):
                mm.copy_(momentum * mm + gg.to(mm.dtype))
                pp.copy_(pp - (lrt * mm.float()).to(pp.dtype))
        return params, state

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": map_sorted(zeros, params),
                "v": map_sorted(zeros, params)}

    def update(grads, state, params, step):
        lrt = _lr_at(lr, step)
        t = torch.as_tensor(step).float() + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            for pp, gg, mm, vv in _slices(p, g, m, v):
                gf = gg.float()
                mm.copy_(b1 * mm + (1 - b1) * gf)
                vv.copy_(b2 * vv + (1 - b2) * gf * gf)
                u = (mm / c1) / (torch.sqrt(vv / c2) + eps)
                if weight_decay:
                    u = u + weight_decay * pp.float()
                pp.copy_((pp.float() - lrt * u).to(pp.dtype))
        return params, state

    return Optimizer(init, update)


def adafactor(lr: Schedule, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Shazeer & Stern (2018) factored second moment, no first moment.
    Each leaf is updated whole: its update's RMS is over all of it."""
    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def per(p):
            if _factored(p):
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"f": map_sorted(per, params)}

    def update(grads, state, params, step):
        lrt = _lr_at(lr, step)
        t = torch.as_tensor(step).float() + 1.0
        beta = 1.0 - t ** (-decay)
        for p, g, s in zip(leaves(params), leaves(grads),
                           _states(params, state["f"])):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p):
                r = beta * s["r"] + (1 - beta) * torch.mean(g2, dim=-1)
                c = beta * s["c"] + (1 - beta) * torch.mean(g2, dim=-2)
                rc = r / torch.clamp_min(torch.mean(r, dim=-1, keepdim=True),
                                         eps)
                vhat = rc[..., None] * c[..., None, :]
                u = gf * torch.rsqrt(torch.clamp_min(vhat, eps))
                s["r"].copy_(r)
                s["c"].copy_(c)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(torch.clamp_min(v, eps))
                s["v"].copy_(v)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_((p.float() - lrt * u).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def _states(params, per_leaf) -> List[dict]:
    """adafactor's per-leaf state dicts, in :func:`leaves` order of the
    parameters (the dicts themselves are the state tree's leaves)."""
    out = []

    def walk(p, s):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], s[k])
        elif isinstance(p, (tuple, list)):
            for a, b in zip(p, s):
                walk(a, b)
        else:
            out.append(s)
    walk(params, per_leaf)
    return out


def build_optimizer(name: str, lr: Schedule = 1e-4, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    if name == "sgd":
        return sgd(lr, **kw)
    raise ValueError(name)
