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
the card. Every update, and the clip's norm, runs over slices of at
most ``CHUNK`` elements, which bounds their f32 temporaries and leaves
every element's arithmetic as it is: adamw and sgd over flat slices;
adafactor over whole matrices or blocks of rows (its statistics and its
update's RMS are sums over slices, taken in a fixed order, then the
update applied slice by slice); the clip's norm a sum of per-slice sums
in order.

Under a mesh a leaf may be this rank's part of a larger one, cut on one
dim or on two (an FSDP dim and a tensor-parallel one, or an expert
stack's: ``launch/sharding.param_shards`` gives each leaf's
:class:`Shard` or None). ``clip_by_global_norm(..., shards=)`` and
``update(..., shards=)`` then see the whole leaf: the part's sum of
squares (its padding excluded) is summed over the ranks that hold the
other parts, in shard order, so the norm is the same bits on every
rank; adafactor's statistics that run along a cut dim (the row mean
over a cut last dim, the column sum and the row statistics' mean over a
cut row dim) are summed over that dim's ranks, and its update's RMS
over every part's, over the whole leaf's size.
adamw and sgd are elementwise and take the part as it is.
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
    # (grads, state, params, step, shards=None) -> (params, state)
    update: Callable


class Cut(NamedTuple):
    """One cut dim of a leaf held as this rank's part of a larger one:
    rows ``lo:hi`` of dim ``axis`` (negative), of a dim of ``whole``
    rows; rows past ``whole`` are padding (zeros that take no
    gradient). ``group`` (a ``utils.mesh.ShardGroup``) holds the ranks
    whose rows tile the dim, in shard order."""
    axis: int
    lo: int
    hi: int
    whole: int
    group: object

    @property
    def valid(self) -> int:
        """The part's rows that are not padding."""
        return max(0, min(self.hi, self.whole) - self.lo)


class Shard(NamedTuple):
    """A leaf held as this rank's part of a larger one, cut on the dims
    of ``cuts`` (one :class:`Cut` each: an FSDP dim and a tensor-parallel
    one, or an expert stack's); ``group`` holds every rank whose part is
    another piece of the leaf (the cuts' axes together), in shard
    order."""
    cuts: tuple
    group: object

    def on(self, axis: int):
        """The :class:`Cut` of dim ``axis`` (negative), or None."""
        return next((c for c in self.cuts if c.axis == axis), None)

    def numel(self, part_shape) -> int:
        """The whole leaf's element count (its padding excluded)."""
        n = 1
        for i, s in enumerate(part_shape):
            c = self.on(i - len(part_shape))
            n *= s if c is None else c.whole
        return n


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


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """The f32 sum of g's squares: each slice's sum, added in order."""
    return sum(torch.sum(piece.float() ** 2) for (piece,) in _slices(g))


def _leaf_sum_of_squares(g: torch.Tensor, shard) -> torch.Tensor:
    """:func:`_sum_of_squares` of a whole leaf, or of a part's rows that
    are not padding summed over the parts' ranks."""
    if shard is None:
        return _sum_of_squares(g)
    for c in shard.cuts:
        if c.valid < c.hi - c.lo:
            g = g.narrow(c.axis, 0, c.valid).contiguous()
    s = _sum_of_squares(g) if g.numel() else torch.zeros(
        (), dtype=torch.float32, device=g.device)
    return shard.group.psum(s.reshape(1))[0]


def clip_by_global_norm(grads, max_norm: float, shards=None):
    """Scale every gradient by ``min(1, max_norm / max(gn, 1e-9))``, in
    f32 and cast back, in place; gn is the global norm of the leaves'
    f32 squares (each leaf's summed slice by slice), added in sorted-key
    order. ``shards`` (one :class:`Shard` or None a leaf, in
    :func:`leaves` order) counts a part as its whole leaf. Returns
    (grads, gn)."""
    gs = leaves(grads)
    shards = shards or [None] * len(gs)
    gn = torch.sqrt(sum(_leaf_sum_of_squares(g, sh)
                        for g, sh in zip(gs, shards)))
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

    def update(grads, state, params, step, shards=None):
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

    def update(grads, state, params, step, shards=None):
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


def _row_blocks(p: torch.Tensor):
    """A factored leaf (..., R, C) as its slices for adafactor: (l0, l1,
    r0, r1) views rows r0:r1 of matrices l0:l1 of the (L, R, C) view.
    Whole matrices, as many a slice as fit in ``CHUNK`` elements; a
    matrix larger than that in blocks of rows."""
    R, C = p.shape[-2:]
    L = p.numel() // (R * C)
    if R * C <= CHUNK:
        n = max(1, CHUNK // (R * C))
        return [(l0, min(L, l0 + n), 0, R) for l0 in range(0, L, n)]
    rows = max(1, CHUNK // C)
    return [(l, l + 1, r0, min(R, r0 + rows))
            for l in range(L) for r0 in range(0, R, rows)]


def adafactor(lr: Schedule, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Shazeer & Stern (2018) factored second moment, no first moment.
    The reference's per-leaf formula (its update's RMS over the whole
    leaf), computed in passes over slices (:func:`_row_blocks` of a
    factored leaf, flat slices of a vector): the row and column means of
    g^2 + eps and the new r and c; then the sum of u^2 over the slices
    in order, for the RMS; then u applied slice by slice."""
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

    def factored(p, g, s, beta, shard):
        """(the slices' (p, g, 1 / sqrt(vhat)) getter, count) of a
        factored leaf, after the new r and c are written into s. A part
        cut on the last dim (C) sums its row means over that cut's
        ranks; one cut on the row dim (R) its column sums and the mean
        of r."""
        R, C = p.shape[-2:]
        L = p.numel() // (R * C)
        cut_c = None if shard is None else shard.on(-1)
        cut_r = None if shard is None else shard.on(-2)
        pv, gv = p.view(L, R, C), g.view(L, R, C)
        r_new = torch.empty((L, R), dtype=torch.float32, device=p.device)
        csum = torch.zeros((L, C), dtype=torch.float32, device=p.device)
        blocks = _row_blocks(p)
        for l0, l1, r0, r1 in blocks:
            gf = gv[l0:l1, r0:r1].float()
            g2 = gf * gf + eps
            r_new[l0:l1, r0:r1] = (torch.sum(g2, dim=-1) if cut_c
                                   else torch.mean(g2, dim=-1))
            if r1 - r0 == R:
                csum[l0:l1] = torch.sum(g2, dim=-2)
            else:
                csum[l0:l1] += torch.sum(g2, dim=-2)
        if cut_c:
            r_new = cut_c.group.psum(r_new) / cut_c.whole
        if cut_r:
            csum, R = cut_r.group.psum(csum), cut_r.whole
        sr, sc = s["r"].view(L, -1), s["c"].view(L, C)
        r = beta * sr + (1 - beta) * r_new
        c = beta * sc + (1 - beta) * (csum / R)
        sr.copy_(r)
        sc.copy_(c)
        if cut_r:
            rmean = cut_r.group.psum(torch.sum(r, dim=-1, keepdim=True)) / R
        else:
            rmean = torch.mean(r, dim=-1, keepdim=True)
        rc = r / torch.clamp_min(rmean, eps)

        def piece(b):
            l0, l1, r0, r1 = b
            vhat = rc[l0:l1, r0:r1, None] * c[l0:l1, None, :]
            return (pv[l0:l1, r0:r1], gv[l0:l1, r0:r1].float(),
                    torch.rsqrt(torch.clamp_min(vhat, eps)))
        return blocks, piece

    def unfactored(p, g, s, beta):
        """As :func:`factored`, for a vector: v updated in place."""
        blocks = list(_slices(p, g, s["v"]))
        for _, gg, vv in blocks:
            gf = gg.float()
            vv.copy_(beta * vv + (1 - beta) * (gf * gf + eps))

        def piece(b):
            pp, gg, vv = b
            return pp, gg.float(), torch.rsqrt(torch.clamp_min(vv, eps))
        return blocks, piece

    def update(grads, state, params, step, shards=None):
        lrt = _lr_at(lr, step)
        t = torch.as_tensor(step).float() + 1.0
        beta = 1.0 - t ** (-decay)
        ps = leaves(params)
        for p, g, s, sh in zip(ps, leaves(grads), _states(params, state["f"]),
                               shards or [None] * len(ps)):
            if not (p.is_contiguous() and g.is_contiguous()):
                raise ValueError("optimizer: the parameters and gradients "
                                 "must be contiguous")
            blocks, piece = (factored(p, g, s, beta, sh) if _factored(p)
                             else unfactored(p, g, s, beta))
            sq = 0
            for b in blocks:
                _, gf, inv = piece(b)
                u = gf * inv
                sq = sq + torch.sum(u * u)
            numel = p.numel()
            if sh is not None:
                # The padded experts' u is 0 (their gradient is 0).
                sq, numel = sh.group.psum(sq.reshape(1))[0], sh.numel(p.shape)
            rms = torch.sqrt(sq / numel + 1e-30)
            div = torch.clamp_min(rms / clip_threshold, 1.0)
            for b in blocks:
                pp, gf, inv = piece(b)
                u = gf * inv / div
                if weight_decay:
                    u = u + weight_decay * pp.float()
                pp.copy_((pp.float() - lrt * u).to(pp.dtype))
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
