"""The serve plane (counterpart of ``repro/fed/plane.py`` without its
encoder part; DESIGN.md §11).

It owns the device computations of the serving hot path — the serve
step, the routed personalization step (DESIGN.md §16, ``heads !=
"off"``) and the fold scatter — and the double-buffered, versioned tau
the steps read. Queues, buckets, policies and refresh cadence live in
``fed/stream.py``.

With ``serve_axes`` (and a ``utils.mesh.Mesh``) the plane is sharded:
the request batch splits over the ranks of those mesh axes, tau, the
heads and the fold state stay replicated, and the fold runs through
``server.aggregate_incremental_sharded``. ``serve_axes`` grants up to
``n_shards`` ranks; the autoscale controller may run a flush on fewer
(``shards=`` on :meth:`ServePlane.step` and :meth:`ServePlane.fold`),
down to one, and a multi-axis grant switches only between 1 and the
whole grant.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import server
from repro_torch.core.lloyd import lloyd_attach
from repro_torch.core.local_kmeans import local_prepare, split_local_kw
from repro_torch.fed.personalize import majority_vote
from repro_torch.kernels import ops
from repro_torch.models.heads import apply_heads

__all__ = ["ServePlane", "ServePlaneError", "TauBuffer", "route_capacity"]


class ServePlaneError(ValueError):
    """A serve-plane configuration failed validation (named, with the
    accepted values), raised at construction."""


class TauBuffer(NamedTuple):
    """Double-buffered tau centers with an atomic version counter.

    ``bufs[active]`` is what the serve step reads; ``stage`` fills the
    standby without touching serving, and ``commit`` flips ``active``
    and bumps ``version`` by one, so a request's recorded version names
    exactly the tau that labelled it. ``swap_now`` is stage + commit.
    Every transition returns a new TauBuffer."""
    bufs: torch.Tensor   # (2, k, d) f32
    active: int          # which buffer serves
    version: int         # bumps exactly once per commit
    pending: bool        # standby staged, swap deferred to a boundary

    @classmethod
    def fresh(cls, tau: torch.Tensor) -> "TauBuffer":
        t = tau.float()
        return cls(torch.stack([t, t]), 0, 0, False)

    @property
    def tau(self) -> torch.Tensor:
        return self.bufs[self.active]

    @property
    def standby(self) -> torch.Tensor:
        return self.bufs[1 - self.active]

    def stage(self, new_tau: torch.Tensor) -> "TauBuffer":
        t = new_tau.float()
        cur = self.bufs[self.active]
        bufs = torch.stack([cur, t] if self.active == 0 else [t, cur])
        return TauBuffer(bufs, self.active, self.version, True)

    def commit(self) -> "TauBuffer":
        return TauBuffer(self.bufs, 1 - self.active, self.version + 1, False)

    def swap_now(self, new_tau: torch.Tensor) -> "TauBuffer":
        return self.stage(new_tau).commit()

    # -- checkpoint plumbing (the arrays the v2+ schema stores) ---------
    def meta_array(self) -> np.ndarray:
        return np.asarray([self.active, self.version, int(self.pending)],
                          np.int64)

    @classmethod
    def from_arrays(cls, bufs: torch.Tensor, meta) -> "TauBuffer":
        m = np.asarray(meta)
        return cls(bufs.float(), int(m[0]), int(m[1]), bool(m[2]))


def _make_step(cfg):
    """The serve-step body: Algorithm 1 steps 1-3 over the request batch,
    then the fused bounded Lloyd + Theorem 3.2 attach + Definition 3.3
    labels in one ``lloyd_attach`` launch (``cfg.serve_dtype`` f32, or
    bf16 storage with f32 accumulation)."""
    prep_kw, max_iters = split_local_kw(cfg.local_kw)

    def step(tau, gumbel, data, point_mask, k_valid):
        prep = local_prepare(gumbel, data, k_max=cfg.k_prime,
                             k_valid=k_valid, point_mask=point_mask,
                             **prep_kw)
        labels, _, centers, _ = lloyd_attach(
            data, prep.theta, tau, center_mask=prep.center_mask,
            point_mask=point_mask, max_iters=max_iters,
            serve_dtype=cfg.serve_dtype)
        return (labels, centers, prep.center_mask,
                server.core_weights(prep.core_counts))

    return step


def route_capacity(batch: int, k: int, factor: float) -> int:
    """Per-cluster dispatch queue depth for a ``batch``-request step:
    ``ceil(batch * factor / k)`` slots (>= 1). ``factor`` is the plan's
    ``head_capacity``; requests past a cluster's queue still get labels,
    just no prediction."""
    return max(1, int(math.ceil(batch * float(factor) / k)))


def _make_routed_step(cfg):
    """The routed personalization step: the label body of
    :func:`_make_step` (labels, centers and fold reports equal the
    heads-off step's), then a per-request majority vote, the
    ``moe_dispatch`` gather of whole requests into per-cluster head
    queues (clusters are the experts), every queue through its own head
    (``models/heads.py``) and the ``moe_combine`` back to request order.
    The routing scatters are int/bool overwrites onto unique slots.

    Sharded, the step gets this shard's rows of the batch and
    ``gather_votes``, which gathers every shard's votes into the whole
    batch's, in shard order, and says where this shard's rows start.
    Keep or overflow is then decided over the whole batch, with
    ``C = route_capacity(whole batch, ...)`` slots a cluster, so the
    sharded plane drops exactly the requests the single-device plane
    drops; dispatch, heads and combine stay on the shard, some of its
    slots empty."""
    spec = cfg.head_spec()
    base = _make_step(cfg)
    k = cfg.k

    def routed(tau, head_params, gumbel, data, point_mask, k_valid,
               gather_votes=None):
        labels, centers, cmask, weights = base(tau, gumbel, data,
                                               point_mask, k_valid)
        B, n_pad, d = data.shape
        dev = data.device
        # One cluster per request, by first-max vote. A row with no
        # valid point takes the out-of-range class k: it matches no
        # cluster, so it never takes a queue slot. (The service's
        # repeat-padding rows hold real points, so they vote and route.)
        cluster = majority_vote(
            torch.where(point_mask, labels, torch.full_like(labels, -1)), k)
        req = point_mask.any(dim=1)
        eff = torch.where(req, cluster, torch.full_like(cluster, k))
        col = torch.clamp_max(eff, k - 1).long()
        rows = torch.arange(B, device=dev)
        ks = torch.arange(k, device=dev, dtype=eff.dtype)
        oh = (eff.unsqueeze(1) == ks).int()
        # Queue position = exclusive running count of earlier requests
        # of the same cluster over the whole batch, in row order; the
        # first C are kept. Sharded, this shard's rows are [off, off + B)
        # of the gathered votes.
        gcl, off = (eff, 0) if gather_votes is None else gather_votes(eff)
        C = route_capacity(gcl.shape[0], k, cfg.head_capacity)
        S = k * C
        goh = (gcl.unsqueeze(1) == ks).int()
        cum = (torch.cumsum(goh, dim=0) - goh)[off:off + B]
        kept = (cum[rows, col] < C) & req
        # Local slot = exclusive running count among this shard's kept
        # rows of the cluster: a subset of the <= C kept over the batch.
        ohl = oh * kept.int().unsqueeze(1)
        lpos = (torch.cumsum(ohl, dim=0) - ohl)[rows, col]
        slot = cluster * C + lpos.int()
        # Invert request -> slot into the dispatch kernel's slot ->
        # request vector. Kept slots are unique; an overflowed request
        # writes to the sentinel slot S, which is sliced off (the
        # reference's out-of-range drop).
        slot_s = torch.where(kept, slot, torch.full_like(slot, S)).long()
        src = torch.zeros((S + 1,), dtype=torch.int32, device=dev)
        src[slot_s] = rows.int()
        valid = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
        valid[slot_s] = True
        src, valid = src[:S], valid[:S]
        # Whole requests gather into queue order (points and validity).
        qdata = ops.moe_dispatch(data.reshape(B, n_pad * d), src,
                                 valid).reshape(k, C, n_pad, d)
        qmask = ops.moe_dispatch(point_mask.float(), src,
                                 valid).reshape(k, C, n_pad) > 0.5
        ybuf = apply_heads(head_params, qdata, qmask, spec,
                           serve_dtype=cfg.serve_dtype)
        # top_k=1 with the keep mask as gates: an overflowed request
        # combines to exactly zero.
        preds = ops.moe_combine(ybuf.reshape(S, d),
                                torch.where(kept, slot,
                                            torch.zeros_like(slot)),
                                kept.float(), top_k=1)
        return labels, centers, cmask, weights, preds, cluster, kept

    return routed


class ServePlane:
    """Serve step, routed step and fold scatter, on one device or
    sharded over the ranks of ``serve_axes``.

    Sharded, at ``s`` active shards shard i < s serves rows
    [i B/s, (i+1) B/s) of a B-request batch: it draws, moves and solves
    only those. The labels are gathered over the whole grant, so every
    rank delivers the whole batch; a rank outside the first s skips the
    step and sends a placeholder that the gather drops. The reports stay
    on the shard that computed them until the fold, whose one gather
    moves them. Per request, every result is the single-device plane's
    bit for bit: a request's computation depends on its own draws and
    points only. The routed step adds one gather, of the requests'
    votes, so that keep or overflow is decided over the whole batch.

    ``compile_count`` counts the first-seen (kind, shards, shape)
    signatures of the steps and folds, as the JAX package's plane counts
    its compiled ones: here each is one distinct shape, and with it one
    set of kernel launch plans. Under autoscaling it stays flat once
    the traffic's (shards, batch, rung) triples have each been seen."""

    @staticmethod
    def validate_mesh_axes(mesh, axes, batch_size: int) -> int:
        """The serve-axes rules (checked by ``Session`` and by the
        plane): returns the shard count, or raises
        :class:`ServePlaneError` naming the field."""
        if not axes or not all(isinstance(a, str) for a in axes):
            raise ServePlaneError(
                f"serve_axes={axes!r} is invalid: must be None "
                f"(single-device serving) or a non-empty tuple of mesh "
                f"axis names, e.g. ('data',)")
        if mesh is None:
            raise ServePlaneError(
                f"serve_axes={tuple(axes)!r} needs a mesh: "
                f"Session(plan, mesh=...)")
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            raise ServePlaneError(
                f"serve_axes={tuple(axes)!r}: axes {missing} not in "
                f"the mesh (available: {list(mesh.shape)})")
        n = mesh.size(axes)
        if batch_size % n:
            raise ServePlaneError(
                f"batch_size={batch_size} is invalid: must be "
                f"divisible by the serve_axes shard count {n} "
                f"(axes {tuple(axes)})")
        return n

    def __init__(self, cfg, device, mesh=None, serve_axes=None):
        self.cfg = cfg
        self.device = torch.device(device)
        axes = tuple(serve_axes) if serve_axes else None
        self.n_shards = (self.validate_mesh_axes(mesh, axes, cfg.batch_size)
                         if axes else 1)
        self.mesh = mesh
        self.axes = axes
        self.group = mesh.group(axes) if axes else None
        self._step = _make_step(cfg)
        self._routed = (_make_routed_step(cfg)
                        if cfg.head_spec() is not None else None)
        self.steps = 0
        self.folds = 0
        self._signatures = set()
        self.compile_count = 0

    def _count(self, kind: str, s: int, shape) -> None:
        sig = (kind, s, tuple(shape))
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.compile_count += 1

    def _shards(self, shards: Optional[int]) -> int:
        s = self.n_shards if shards is None else int(shards)
        if not 1 <= s <= self.n_shards:
            raise ServePlaneError(
                f"shards={s} is invalid: the plan's serve_axes grant "
                f"1..{self.n_shards} active shards")
        if s not in (1, self.n_shards) and len(self.axes) > 1:
            raise ServePlaneError(
                f"shards={s} is invalid: multi-axis serve_axes "
                f"{self.axes!r} only switch between 1 and the full "
                f"grant ({self.n_shards})")
        return s

    def rows(self, B: int, shards: Optional[int] = None) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a B-request batch at ``shards``
        active shards: all of them on a single-device plane, none
        (lo == hi) on a rank outside the active shards."""
        if self.group is None:
            return 0, B
        s = self._shards(shards)
        b = B // s
        i = self.group.index
        return (i * b, (i + 1) * b) if i < s else (0, 0)

    def _inputs(self, source, rids, data, point_mask, k_valid):
        """A host batch on the device, with its k-means++ draws."""
        dev = self.device
        return (source.draw([int(r) for r in rids], self.cfg.k_prime,
                            data.shape[1], dev),
                torch.from_numpy(np.ascontiguousarray(data)).to(dev),
                torch.from_numpy(np.ascontiguousarray(point_mask)).to(dev),
                torch.from_numpy(np.ascontiguousarray(k_valid)).to(dev))

    def step(self, tau, source, rids, data, point_mask, k_valid,
             shards: Optional[int] = None):
        """Serve one fixed-shape batch given on the host: ``data``
        (B, n_pad, d) f32, ``point_mask`` (B, n_pad), ``k_valid`` (B,)
        and the request ids ``rids`` that key each request's draws from
        ``source``. ``shards``: the active shard count (default: the
        whole grant). Returns (labels (B, n_pad) of the whole batch, and
        this rank's rows of the reports: centers (b, k', d), center_mask
        (b, k'), core weights (b, k'))."""
        B, n_pad, d = data.shape
        s = self._shards(shards) if self.group is not None else 1
        self.steps += 1
        self._count("step", s, data.shape)
        lo, hi = self.rows(B, s)
        if hi > lo:
            out = self._step(tau, *self._inputs(
                source, rids[lo:hi], data[lo:hi], point_mask[lo:hi],
                k_valid[lo:hi]))
        else:
            out = self._placeholder(B // s, n_pad, d)
        if self.group is None:
            return out
        return (self.group.all_gather(out[0], active=s),) + tuple(out[1:])

    def routed_step(self, tau, head_params, source, rids, data, point_mask,
                    k_valid, shards: Optional[int] = None):
        """Serve one host batch (as :meth:`step`) through the per-cluster
        heads. Returns the :meth:`step` quadruple plus (preds (B, d) f32,
        cluster (B,) int32, kept (B,) bool) of the whole batch; preds
        are zero and kept is False where the request overflowed its
        cluster's queue. Sharded, the votes are gathered once to decide
        the overflow over the whole batch, and labels, preds, cluster
        and kept in one more gather."""
        B, n_pad, d = data.shape
        s = self._shards(shards) if self.group is not None else 1
        self.steps += 1
        self._count("routed", s, data.shape)
        if self.group is None:
            return self._routed(tau, head_params, *self._inputs(
                source, rids, data, point_mask, k_valid))
        lo, hi = self.rows(B, s)
        if hi > lo:
            out = self._routed(
                tau, head_params, *self._inputs(
                    source, rids[lo:hi], data[lo:hi], point_mask[lo:hi],
                    k_valid[lo:hi]),
                gather_votes=lambda eff: (
                    self.group.all_gather(eff, active=s), lo))
        else:
            b, dev = B // s, self.device
            # A placeholder's votes, dropped by the gather.
            votes = torch.zeros((b,), dtype=torch.int32, device=dev)
            self.group.all_gather(votes, active=s)
            out = self._placeholder(b, n_pad, d) + (
                torch.zeros((b, d), device=dev), votes,
                torch.zeros((b,), dtype=torch.bool, device=dev))
        labels, preds, cluster, kept = self.group.all_gather_many(
            [out[0], out[4], out[5], out[6]], active=s)
        return (labels,) + tuple(out[1:4]) + (preds, cluster, kept)

    def _placeholder(self, b: int, n_pad: int, d: int):
        """What a rank outside the active shards contributes in place of
        a step's labels and reports (b rows, dropped by the gathers)."""
        kp, dev = self.cfg.k_prime, self.device
        return (torch.zeros((b, n_pad), dtype=torch.int32, device=dev),
                torch.zeros((b, kp, d), device=dev),
                torch.zeros((b, kp), dtype=torch.bool, device=dev),
                torch.zeros((b, kp), device=dev))

    def gather_rows(self, x: torch.Tensor,
                    shards: Optional[int] = None) -> torch.Tensor:
        """The whole batch of a per-request tensor of which this rank
        holds its :meth:`rows` (itself on a single-device plane)."""
        if self.group is None:
            return x
        return self.group.all_gather(x, active=self._shards(shards))

    def localize(self, x) -> torch.Tensor:
        """A tensor on the plane's device."""
        return torch.as_tensor(x, device=self.device)

    def fold(self, state, slots, centers, cmask, weights=None, epochs=None,
             shards: Optional[int] = None):
        """Scatter one batch of admitted reports into the fold state.
        ``slots`` (B,) cover the whole batch; slots at or beyond the
        capacity are dropped. ``epochs``: the request ids stamped on the
        slots (default: the slots). With ``shards`` on a sharded plane,
        the reports are this rank's rows of the step at that shard
        count and the sharded fold gathers them; otherwise they are the
        whole batch on every rank (the round's seeding)."""
        self.folds += 1
        B = int(slots.shape[0])
        slots = torch.as_tensor(slots).to(self.device)
        epochs = slots if epochs is None else torch.as_tensor(epochs).to(
            self.device)
        if weights is None:
            weights = torch.ones(cmask.shape, dtype=torch.float32,
                                 device=self.device)
        if self.group is None or shards is None:
            self._count("fold", 1, (B,) + tuple(centers.shape[1:]))
            return server.aggregate_incremental(
                state, slots, centers, cmask, weights=weights,
                epochs=epochs)
        s = self._shards(shards)
        self._count("fold", s, (B,) + tuple(centers.shape[1:]))
        lo, hi = self.rows(B, s)
        if hi == lo:  # a placeholder's rows, dropped by the gather
            lo, hi = 0, B // s
        return server.aggregate_incremental_sharded(
            state, slots[lo:hi], centers, cmask, self.group,
            weights=weights, epochs=epochs[lo:hi], active=s)

    def describe(self) -> dict:
        return {"serve_axes": list(self.axes) if self.axes else None,
                "serve_shards": self.n_shards,
                "chunk_rows": ops.CHUNK_ROWS,
                "plane_compiles": self.compile_count,
                "serve_device": str(self.device),
                "plane_steps": self.steps, "plane_folds": self.folds}
