"""The k-FED server, Algorithm 2 steps 2-8 (counterpart of
``repro/core/server.py``, without its sharded and drift parts).

On top of the one-shot :func:`aggregate` the server has an incremental
fold — :func:`init_state` / :func:`aggregate_incremental` /
:func:`finalize` — that buffers device reports by device id, so cohorts
may report in any order across many calls and the finalized aggregate
does not depend on the order. The max-min seeding, which does, runs at
:func:`finalize`.
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
                *, weights: Optional[torch.Tensor] = None,
                center_mask: Optional[torch.Tensor] = None):
    """Steps 7-8 of Algorithm 2: ONE Lloyd round of the device centers
    against the seeded set M; with ``weights`` the weighted mean. A
    center is divided by its actual mass whenever that is positive, and
    a zero-mass center keeps its seed. Returns (tau (k, d) f32,
    labels (m,) int32)."""
    labels, _ = L.assign_points(x, M, center_mask=center_mask, point_mask=fm)
    w = None if weights is None else weights.float()
    sums, cnt = ops.kmeans_update(x.float(), labels, k, w)
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


def finalize(state: ServerState, k: int, *,
             weighted: bool = False) -> KFedAggregate:
    """Run Algorithm 2 over every report received so far. Devices that
    never reported are masked out (their labels come out -1); attach
    them afterwards with :func:`attach_absent_devices`."""
    mask = state.mask & state.received[:, None]
    return aggregate(state.centers, mask, k,
                     weights=state.weights if weighted else None)
