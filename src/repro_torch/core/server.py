"""The k-FED server, Algorithm 2 steps 2-8 (counterpart of
``repro/core/server.py``).

The replicated server (:func:`aggregate`, also the simulated path's) and
the sharded one (:func:`aggregate_sharded`, where each shard owns its
slice of the device centers) differ only in the reducer handed to the
shared greedy max-min loop (``lloyd.maxmin_grow``) and to the one Lloyd
round (:func:`lloyd_round`): ``lloyd.LocalReducer`` or the collective
:class:`ShardedReducer`.

On top of the one-shot :func:`aggregate` the server has an incremental
fold — :func:`init_state` / :func:`aggregate_incremental` /
:func:`finalize` — that buffers device reports by device id, so cohorts
may report in any order across many calls and the finalized aggregate
does not depend on the order. The max-min seeding, which does, runs at
:func:`finalize`.

The drift layer (DESIGN.md §14) is pure functions of the fold state:
:func:`decay_factors` / :func:`decayed_evidence` weight every slot by its
age, :func:`center_mass` sums the decayed weights per center, and
:func:`split_retire` re-seeds starved centers from over-massed ones.
They reproduce the JAX package's f32 arithmetic on the CPU, where XLA
flushes to zero: a factor whose exponent is at or below -126 is 0 (XLA's
``exp2`` returns 0 there, though 2^-126 is a normal f32) and a subnormal
weight is 0. PyTorch keeps both on every device, so the rule is written
out here, on the CPU and on CUDA alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import lloyd as L
from repro_torch.kernels import ops


class KFedAggregate(NamedTuple):
    seeds_idx: torch.Tensor      # (k,) indices into flattened (Z*k') centers
    seed_centers: torch.Tensor   # (k, d) the set M
    tau_centers: torch.Tensor    # (k, d) mu(tau_r) after the one Lloyd round
    center_labels: torch.Tensor  # (Z, k') tau-label of each device center
    z0: torch.Tensor             # () the device whose centers seeded M


def lloyd_round(x: torch.Tensor, fm: torch.Tensor, M: torch.Tensor, k: int,
                *, reducer=None, weights: Optional[torch.Tensor] = None,
                center_mask: Optional[torch.Tensor] = None):
    """Steps 7-8 of Algorithm 2: ONE Lloyd round of the device centers
    against the seeded set M; with ``weights`` the weighted mean.
    ``reducer.psum`` combines the partial sums and counts of the server's
    shards (the identity for the replicated server). A center is divided
    by its actual mass whenever that is positive, and a zero-mass center
    keeps its seed. Returns (tau (k, d) f32, labels (m,) int32)."""
    reducer = reducer or L.LocalReducer()
    labels, _ = L.assign_points(x, M, center_mask=center_mask, point_mask=fm)
    w = None if weights is None else weights.float()
    sums, cnt = ops.kmeans_update(x.float(), labels, k, w)
    sums = reducer.psum(sums)
    cnt = reducer.psum(cnt)
    pos = cnt > 0
    tau = torch.where(pos[:, None],
                      sums / torch.where(pos, cnt, torch.ones_like(cnt))[:, None],
                      M.float())
    return tau, labels


def induced_labels(center_labels: torch.Tensor,
                   local_assign: torch.Tensor) -> torch.Tensor:
    """Definition 3.3: point i on device z with local cluster s gets label
    tau(theta_s^(z)). center_labels: (Z, k'), local_assign: (Z, n)."""
    safe = torch.clamp(local_assign, 0, center_labels.shape[1] - 1).long()
    lbl = torch.gather(center_labels, 1, safe)
    return torch.where(local_assign >= 0, lbl, torch.full_like(lbl, -1))


def assign_new_device(new_centers: torch.Tensor, new_mask: torch.Tensor,
                      ref_centers: torch.Tensor) -> torch.Tensor:
    """Theorem 3.2: a device that joins after clustering is labelled by
    nearest-neighbour matching of its local centers against the k
    retained centers. new_centers: (k', d) or (Z, k', d); ref_centers:
    (k, d)."""
    labels, _ = L.assign_points(new_centers, ref_centers, point_mask=new_mask)
    return labels


def core_weights(core_counts: torch.Tensor) -> torch.Tensor:
    """Per-center weights for the server Lloyd round: the Algorithm 1
    core set sizes |S_r|, clamped to >= 1."""
    return torch.clamp_min(core_counts.float(), 1.0)


def attach_absent_devices(center_labels: torch.Tensor,
                          device_centers: torch.Tensor,
                          center_mask: torch.Tensor,
                          tau_centers: torch.Tensor,
                          participation: torch.Tensor) -> torch.Tensor:
    """Devices that missed the round take their center labels from the
    Theorem 3.2 nearest-center rule against the retained tau centers."""
    post = assign_new_device(device_centers, center_mask, tau_centers)
    return torch.where(participation[:, None], center_labels, post)


def aggregate(device_centers: torch.Tensor, center_mask: torch.Tensor,
              k: int, *, weights: Optional[torch.Tensor] = None
              ) -> KFedAggregate:
    """Steps 2-8 of Algorithm 2 on a full (Z, k', d) center tensor.
    ``weights``: optional (Z, k') per-center weights for the Lloyd round."""
    Z, kp, d = device_centers.shape
    flat = device_centers.reshape(Z * kp, d)
    fm = center_mask.reshape(Z * kp)

    # "Pick any z": the device with the most local clusters, first wins.
    kz = torch.sum(center_mask, dim=1)
    z0 = torch.argmax(kz).to(torch.int32)
    dev_ids = torch.arange(Z, device=device_centers.device)
    init_sel = ((dev_ids == z0)[:, None] & center_mask).reshape(-1)

    seeds_idx = L.maxmin_seed(flat, fm, init_sel, k)
    M = flat[seeds_idx.long()]

    w = None if weights is None else weights.reshape(Z * kp)
    tau, labels = lloyd_round(flat, fm, M, k, weights=w)
    return KFedAggregate(seeds_idx, M, tau.to(device_centers.dtype),
                         labels.reshape(Z, kp), z0)


_BIG = 2 ** 30


class ShardedReducer:
    """Collective counterpart of ``lloyd.LocalReducer`` over a
    ``utils.mesh.ShardGroup``: each shard owns rows [base, base + m_loc)
    of the global point set. argmax resolves ties to the smallest global
    index (the first occurrence, as the local argmax does)."""

    def __init__(self, group, base: int, m_loc: int):
        self.group, self.base, self.m_loc = group, int(base), int(m_loc)

    def argmax(self, vals: torch.Tensor) -> torch.Tensor:
        lmax = torch.amax(vals)
        larg = torch.argmax(vals).to(torch.int32)
        gmax = self.group.pmax(lmax)
        return self.group.pmin(torch.where(
            lmax >= gmax, self.base + larg,
            torch.full_like(larg, _BIG)))

    def _owned(self, gidx: torch.Tensor):
        mine = (gidx >= self.base) & (gidx < self.base + self.m_loc)
        rows = torch.clamp(gidx - self.base, 0, self.m_loc - 1).long()
        return mine, rows

    def fetch_row(self, points: torch.Tensor,
                  gidx: torch.Tensor) -> torch.Tensor:
        """The row of global index ``gidx``: the owner contributes it,
        the other shards add 0."""
        mine, row = self._owned(gidx)
        return self.group.psum(torch.where(mine, points[row],
                                           torch.zeros_like(points[row])))

    def fetch_rows(self, points: torch.Tensor,
                   gidx: torch.Tensor) -> torch.Tensor:
        """(k,) global indices -> (k, d) rows, the owner contributing
        each (a row of zeros for an index no shard owns)."""
        mine, rows = self._owned(gidx)
        got = points[rows]
        return self.group.psum(torch.where(mine[:, None], got,
                                           torch.zeros_like(got)))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.psum(x)


def aggregate_sharded(centers_loc: torch.Tensor, mask_loc: torch.Tensor,
                      kz_all: torch.Tensor, k: int, group, base: int, *,
                      weights_loc: Optional[torch.Tensor] = None):
    """Steps 2-8 of Algorithm 2 with the server itself sharded over
    ``group`` (a ``utils.mesh.ShardGroup``): each shard owns its
    m_loc = Z_loc*k' rows of the device centers. Every greedy max-min
    step is a local argmax, a pmax and a pmin of scalars and a psum of
    the winning (d,) row; the selection order is the replicated
    server's (first-occurrence argmax = smallest global index).

    centers_loc: (Z_loc, k', d); mask_loc: (Z_loc, k'); kz_all: (Z,)
    every device's local cluster count; ``base`` = this shard's first
    global row. Returns (M (k, d), tau_centers (k, d), my_labels
    (Z_loc, k'))."""
    Z_loc, kp, d = centers_loc.shape
    m_loc = Z_loc * kp
    dev = centers_loc.device
    pf = centers_loc.reshape(m_loc, d).float()
    fm = mask_loc.reshape(m_loc)
    shard = base // m_loc
    red = ShardedReducer(group, base, m_loc)

    # "Pick any z": the device with the most local clusters, first wins.
    z0 = torch.argmax(kz_all).to(torch.int32)
    rows = torch.arange(m_loc, device=dev)
    init_loc = (rows // kp == (z0 - shard * Z_loc)) & fm
    count0 = red.psum(torch.sum(init_loc).to(torch.int32))

    # The initial chosen indices (global, ascending), the owner's win.
    cand = torch.where(init_loc, base + rows.to(torch.int32),
                       torch.full((m_loc,), _BIG, dtype=torch.int32,
                                  device=dev))
    if m_loc < k:
        cand = torch.cat([cand, torch.full((k - m_loc,), _BIG,
                                           dtype=torch.int32, device=dev)])
    chosen0 = group.pmin(torch.sort(cand).values[:k])
    # The owner gathers its initial rows into slot order by a one-hot
    # product (at most one row feeds a slot), never a float scatter-add;
    # the other shards contribute 0.
    slot_of = torch.cumsum(init_loc.to(torch.int32), 0) - 1
    slots = torch.arange(k, device=dev, dtype=torch.int32)
    sel = ((slot_of[:, None] == slots[None, :])
           & init_loc[:, None]).float()                     # (m_loc, k)
    M0 = red.psum(sel.T @ torch.where(init_loc[:, None], pf,
                                      torch.zeros_like(pf)))

    d2 = ops.pairwise_sq_dists(pf, M0)                      # (m_loc, k)
    ok = slots < count0
    mind2 = torch.amin(torch.where(ok[None, :], d2,
                                   torch.full_like(d2, float("inf"))), dim=1)
    mind2 = torch.where(fm, mind2, torch.full_like(mind2, float("-inf")))
    chosen = torch.where(ok, chosen0, torch.full_like(chosen0, -1))

    # The replicated server's greedy growth loop, collective reducer.
    chosen = L.maxmin_grow(pf, fm, chosen, mind2, count0, k, reducer=red)

    # M from the owners; one local Lloyd assignment, one global update.
    M = red.fetch_rows(pf, chosen)
    w = None if weights_loc is None else weights_loc.reshape(m_loc)
    tau, labels = lloyd_round(pf, fm, M, k, reducer=red, weights=w,
                              center_mask=chosen >= 0)
    return M, tau.to(centers_loc.dtype), labels.reshape(Z_loc, kp)


class ServerState(NamedTuple):
    """Fold state of the asynchronous server: device reports buffered by
    device id, so folding the same cohorts in any order gives the same
    state. ``epoch`` stamps each slot with the request id it was folded
    at."""
    centers: torch.Tensor    # (Z, k', d) buffered Theta^(z)
    mask: torch.Tensor       # (Z, k') center validity of received reports
    weights: torch.Tensor    # (Z, k') f32 per-center weights (1.0 default)
    received: torch.Tensor   # (Z,) bool — device has reported this round
    epoch: torch.Tensor      # (Z,) i32 request-id epoch of the fold


def init_state(Z: int, k_prime: int, d: int, dtype=torch.float32,
               device="cuda") -> ServerState:
    return ServerState(
        torch.zeros((Z, k_prime, d), dtype=dtype, device=device),
        torch.zeros((Z, k_prime), dtype=torch.bool, device=device),
        torch.ones((Z, k_prime), dtype=torch.float32, device=device),
        torch.zeros((Z,), dtype=torch.bool, device=device),
        torch.zeros((Z,), dtype=torch.int32, device=device))


def aggregate_incremental(state: ServerState, device_ids, centers, mask,
                          weights=None, epochs=None) -> ServerState:
    """Fold one cohort's reports into the server state: an overwrite
    index-put per leaf, never an accumulating scatter.

    device_ids: (B,) non-negative ints; centers: (B, k', d); mask:
    (B, k'). Ids at or beyond the state's capacity are dropped (the
    JAX package's ``mode="drop"``): over-capacity reports are served,
    not folded. Re-delivering a report is idempotent. ``epochs``:
    optional (B,) request ids stamped on the slots (default: the ids)."""
    dev = state.centers.device
    ids = torch.as_tensor(device_ids, device=dev).long().reshape(-1)
    keep = ids < state.received.shape[0]
    w = (torch.ones(mask.shape, dtype=torch.float32, device=dev)
         if weights is None else weights.float())
    e = ids if epochs is None else torch.as_tensor(epochs, device=dev).long()
    sel = ids[keep]

    def put(leaf, vals):
        out = leaf.clone()
        out[sel] = vals[keep].to(leaf.dtype)
        return out

    return ServerState(
        put(state.centers, centers), put(state.mask, mask),
        put(state.weights, w),
        put(state.received, torch.ones_like(ids, dtype=torch.bool)),
        put(state.epoch, e))


def aggregate_incremental_sharded(state: ServerState, device_ids, centers,
                                  mask, group, weights=None, epochs=None, *,
                                  active: Optional[int] = None
                                  ) -> ServerState:
    """The collective path of :func:`aggregate_incremental`, the fold of
    the sharded serve plane: ``state`` is replicated, ``device_ids`` /
    ``centers`` / ``mask`` / ``weights`` / ``epochs`` are this shard's
    rows of the report batch. One tiled gather over ``group`` (a
    ``utils.mesh.ShardGroup``) moves the batch, the reports and never the
    fold state, and every shard applies the one
    :func:`aggregate_incremental` scatter; gathering keeps the global
    batch order, so the result is bit for bit the unsharded fold's.
    With ``active``, only the first ``active`` shards hold rows (see
    ``ShardGroup.all_gather``)."""
    dev = state.centers.device
    ids = torch.as_tensor(device_ids, device=dev).to(torch.int32)
    w = (torch.ones(mask.shape, dtype=torch.float32, device=dev)
         if weights is None else weights.float())
    e = ids if epochs is None else torch.as_tensor(
        epochs, device=dev).to(torch.int32)
    ids, centers, mask, w, e = group.all_gather_many(
        [ids, centers, mask, w, e], active=active)
    return aggregate_incremental(state, ids, centers, mask, weights=w,
                                 epochs=e)


# The f32 exponent at and below which XLA's exp2 gives exactly 0, and the
# smallest normal f32 (XLA flushes the subnormal products below it).
_EXP2_ZERO_AT = -126.0
_F32_TINY = torch.finfo(torch.float32).tiny


def decay_factors(epoch: torch.Tensor, now_epoch,
                  half_life) -> torch.Tensor:
    """Per-slot exponential decay 2^(-(now - epoch) / half_life) in f32:
    a slot folded ``half_life`` requests ago carries half its mass. The
    age is an int32 difference cast to f32 and divided by an f32
    ``half_life``, as the JAX package forms it; the factor is 0 wherever
    that exponent is <= -126 (XLA's underflow on the CPU), so a slot the
    reference drops is dropped here on every device."""
    now = torch.tensor(int(now_epoch), dtype=torch.int32, device=epoch.device)
    age = (now - epoch.to(torch.int32)).float()
    arg = -age / torch.tensor(float(half_life), dtype=torch.float32,
                              device=epoch.device)
    return torch.where(arg <= _EXP2_ZERO_AT, torch.zeros_like(arg),
                       torch.exp2(arg))


def decayed_evidence(state: ServerState, now_epoch, half_life):
    """The (mask, weights) a drift finalize sees: received reports with
    their fold weights scaled by :func:`decay_factors`, a subnormal
    product flushed to 0 (XLA's rule). A slot whose decayed weight is 0
    is masked out: a zero-mass center must never seed or anchor a
    cluster."""
    fac = decay_factors(state.epoch, now_epoch, half_life)
    w = state.weights * fac[:, None]
    w = torch.where(w.abs() < _F32_TINY, torch.zeros_like(w), w)
    mask = state.mask & state.received[:, None] & (w > 0)
    return mask, w


def finalize(state: ServerState, k: int, *, weighted: bool = False,
             decay=None) -> KFedAggregate:
    """Run Algorithm 2 over every report received so far. Devices that
    never reported are masked out (their labels come out -1); attach
    them afterwards with :func:`attach_absent_devices`.

    ``decay``: optional ``(now_epoch, half_life)``: every slot weighted
    by its age factor (always weighted). The masked slots' coordinates
    are zeroed too: a zero weight does not keep a NaN out of the
    weighted Lloyd sums (0 * NaN is NaN)."""
    if decay is None:
        mask = state.mask & state.received[:, None]
        return aggregate(state.centers, mask, k,
                         weights=state.weights if weighted else None)
    mask, w = decayed_evidence(state, *decay)
    centers = torch.where(mask[..., None], state.centers,
                          torch.zeros_like(state.centers))
    return aggregate(centers, mask, k, weights=w)


def center_mass(agg: KFedAggregate, mask: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Per-center attached fold mass: the sum of the (decayed) slot
    weights whose device centers labelled into each tau center, (k,)
    f32. A one-hot product, as the reference's ``dot_general``: the
    split/retire thresholds read this mass, so it must replay bit for
    bit, and a float ``index_add_`` adds in the order of CUDA's atomics."""
    k = agg.tau_centers.shape[0]
    lbl = agg.center_labels.reshape(-1)
    w = torch.where(mask.reshape(-1) & (lbl >= 0), weights.reshape(-1),
                    torch.zeros_like(weights.reshape(-1)))
    oh = (lbl[:, None] == torch.arange(k, dtype=lbl.dtype,
                                       device=lbl.device)[None, :]).float()
    return w.float() @ oh


def split_retire(flat: torch.Tensor, fm: torch.Tensor, agg: KFedAggregate,
                 mass: torch.Tensor, k: int, *, split_factor: float,
                 retire_frac: float, max_moves: int,
                 weights: Optional[torch.Tensor] = None):
    """Mass-driven center split/retire at a flush boundary.

    Centers with mass below ``retire_frac`` of the mean are starved,
    those above ``split_factor`` times the mean over-massed. Up to
    ``max_moves`` starved centers (poorest first) are re-seeded at the
    farthest attached report of an over-massed donor (fattest first),
    then ONE :func:`lloyd_round` re-anchors all k centers (on the card:
    one ``pdist_argmin`` and one ``kmeans_update`` launch). Stable sorts
    and first-occurrence argmaxes (a donor with no attached report gives
    index 0, as ``jnp.argmax`` of a column of -inf does) make every
    decision replay bit for bit.

    ``flat``: (Z*k', d) device centers; ``fm``: (Z*k',) evidence mask;
    ``weights``: optional (Z*k',) Lloyd weights. Returns ``(tau (k, d)
    f32, moved (k,) bool, donors (k,) int32 (-1 where not moved),
    n_moves () int32)``; with zero moves ``tau`` is ``agg.tau_centers``
    exactly."""
    dev = flat.device
    f32 = dict(dtype=torch.float32, device=dev)
    mass = mass.float()
    mean = torch.sum(mass) / torch.tensor(float(k), **f32)
    starved = mass < torch.tensor(float(retire_frac), **f32) * mean
    over = mass > torch.tensor(float(split_factor), **f32) * mean
    n_mv = torch.minimum(
        torch.minimum(torch.sum(starved), torch.sum(over)),
        torch.tensor(int(max_moves), device=dev)).to(torch.int32)

    # Rank the starved ascending by mass and the donors descending, and
    # pair rank j with rank j; stable sorts give ties to the lowest index.
    inf = torch.full_like(mass, float("inf"))
    sorder = torch.argsort(torch.where(starved, mass, inf), stable=True)
    oorder = torch.argsort(torch.where(over, -mass, inf),
                           stable=True).to(torch.int32)
    ar = torch.arange(k, dtype=torch.int32, device=dev)
    srank = torch.zeros((k,), dtype=torch.int32, device=dev)
    srank[sorder] = ar
    donors = oorder[torch.clamp(srank, 0, k - 1).long()]
    take = starved & (srank < n_mv)

    # The residual re-seed: within each donor cluster, the attached
    # report farthest from its tau center.
    lbl = agg.center_labels.reshape(-1)
    tau0 = agg.tau_centers.float()
    d2 = ops.pairwise_sq_dists(flat.float(), tau0)
    attached = (lbl[:, None] == ar[None, :]) & fm[:, None]
    scores = torch.where(attached, d2, torch.full_like(d2, float("-inf")))
    reseed_idx = torch.argmax(scores, dim=0)                 # (k,)
    M1 = torch.where(take[:, None], flat[reseed_idx[donors.long()]].float(),
                     tau0)

    tau2, _ = lloyd_round(flat, fm, M1, k, weights=weights)
    tau = torch.where(n_mv > 0, tau2, tau0)
    donors = torch.where(take, donors, torch.full_like(donors, -1))
    return tau, take, donors, n_mv
