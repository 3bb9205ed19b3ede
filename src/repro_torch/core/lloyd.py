"""Masked k-means primitives shared by Algorithm 1 (local) and Algorithm 2
(server) of k-FED (counterpart of ``repro/core/lloyd.py``).

Shapes are fixed and mask-driven: padded points carry ``point_mask ==
False`` and padded centers ``center_mask == False``. Where the JAX
package ``vmap``s over devices, these functions take a leading batch
axis written out, and each device's loop is still its own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops


def assign_points(x: torch.Tensor, centers: torch.Tensor,
                  center_mask: Optional[torch.Tensor] = None,
                  point_mask: Optional[torch.Tensor] = None):
    """Nearest-center assignment; invalid points get label -1.

    x: (..., n, d); centers: (..., k, d) or shared (k, d). Returns
    (assign (..., n) int32, min_sq_dist (..., n) f32)."""
    idx, mind = ops.assign_argmin(x, centers, center_mask)
    if point_mask is not None:
        idx = torch.where(point_mask, idx, torch.full_like(idx, -1))
        mind = torch.where(point_mask, mind, torch.zeros_like(mind))
    return idx, mind


def update_centers(x: torch.Tensor, assign: torch.Tensor, k: int,
                   old_centers: torch.Tensor):
    """Mean of assigned points per center; empty centers keep old value."""
    sums, cnt = ops.kmeans_update(x, assign, k)
    new = sums / torch.clamp_min(cnt, 1.0).unsqueeze(-1)
    new = torch.where((cnt > 0).unsqueeze(-1), new, old_centers.float())
    return new.to(old_centers.dtype), cnt


def kmeans_cost(x: torch.Tensor, centers: torch.Tensor,
                center_mask: Optional[torch.Tensor] = None,
                point_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The k-means objective phi (eq. 1) of ``x`` against ``centers``
    (summed over the last point axis)."""
    _, mind = assign_points(x, centers, center_mask, point_mask)
    return torch.sum(mind, dim=-1)


class LloydResult(NamedTuple):
    centers: torch.Tensor     # (..., k, d)
    assign: torch.Tensor      # (..., n) int32, -1 for masked points
    iters: torch.Tensor       # (...) int32
    converged: torch.Tensor   # (...) bool


def lloyd(x: torch.Tensor, centers0: torch.Tensor, *,
          center_mask: Optional[torch.Tensor] = None,
          point_mask: Optional[torch.Tensor] = None,
          max_iters: int = 100) -> LloydResult:
    """Lloyd iterations until the assignment is stable (or max_iters).

    The convergence loop of step 4 of Algorithm 1. x: (n, d) or
    (B, n, d) with centers0 of the same rank. In a batch every device
    keeps its own iteration count: a device whose assignment is stable
    is frozen (centers, assignment and count) while the others go on,
    as under ``vmap`` of the JAX package's while loop.
    """
    if x.dim() == 2:
        res = lloyd(x[None], centers0[None],
                    center_mask=None if center_mask is None
                    else center_mask[None],
                    point_mask=None if point_mask is None
                    else point_mask[None], max_iters=max_iters)
        return LloydResult(*(t[0] for t in res))
    B, n, _ = x.shape
    k = centers0.shape[1]
    dev = x.device
    centers = centers0
    prev = torch.full((B, n), -2, dtype=torch.int32, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        live = ~done
        if not bool(live.any()):
            break
        a, _ = assign_points(x, centers, center_mask, point_mask)
        new, _ = update_centers(x, a, k, centers)
        centers = torch.where(live[:, None, None], new, centers)
        done = done | (live & torch.all(a == prev, dim=-1))
        prev = torch.where(live[:, None], a, prev)
        it = it + live.to(torch.int32)
    # One final assignment against the final centers.
    assign, _ = assign_points(x, centers, center_mask, point_mask)
    return LloydResult(centers, assign, it, done)


def lloyd_attach(x: torch.Tensor, centers0: torch.Tensor, tau: torch.Tensor,
                 *, center_mask: Optional[torch.Tensor] = None,
                 point_mask: Optional[torch.Tensor] = None,
                 max_iters: int = 100, serve_dtype: str = "f32"):
    """The fused serve step: the ``lloyd`` convergence loop, the
    Theorem 3.2 attach of its centers against ``tau`` and the
    Definition 3.3 induced labels, in one kernel launch per batch.

    x (B, n, d), centers0 (B, k', d), tau (k, d) shared. Returns
    (labels (B, n) i32, min_sq_dist (B, n) f32, centers (B, k', d) f32,
    center_labels (B, k') i32)."""
    return ops.solve_attach(x, centers0, tau, center_mask, point_mask,
                            max_iters=max_iters, dtype=serve_dtype)


def kmeans_pp_init(gumbel: torch.Tensor, x: torch.Tensor, k: int, *,
                   point_mask: Optional[torch.Tensor] = None,
                   k_valid: Optional[torch.Tensor] = None):
    """k-means++ seeding (Algorithm 1 step 2), masked and fixed-shape.

    gumbel: (B, k, n) Gumbel noise from a ``utils.prng.GumbelSource``
    (row t drives pick t, as ``jax.random.categorical`` would); x:
    (B, n, d); k_valid: (B,) picks per device (<= k). Returns
    (centers (B, k, d), center_mask (B, k) bool)."""
    B, n, d = x.shape
    dev = x.device
    pm = (torch.ones((B, n), dtype=torch.bool, device=dev)
          if point_mask is None else point_mask)
    kv = (torch.full((B,), k, dtype=torch.int32, device=dev)
          if k_valid is None else torch.as_tensor(k_valid, device=dev))
    xf = x.float()
    rows = torch.arange(B, device=dev)
    neg_inf = torch.full((B, n), float("-inf"), device=dev)

    logits0 = torch.where(pm, torch.zeros_like(neg_inf), neg_inf)
    i0 = torch.argmax(gumbel[:, 0] + logits0, dim=-1)
    c0 = xf[rows, i0]
    centers = torch.zeros((B, k, d), dtype=torch.float32, device=dev)
    centers[:, 0] = c0
    mind2 = torch.where(pm, torch.sum((xf - c0[:, None]) ** 2, dim=-1),
                        torch.zeros_like(logits0))
    for t in range(1, k):
        w = torch.where(pm, mind2, torch.zeros_like(mind2))
        pos = w > 0
        logits = torch.where(pos, torch.log(torch.clamp_min(w, 1e-30)),
                             neg_inf)
        logits = torch.where(pos.any(dim=-1, keepdim=True), logits, logits0)
        i = torch.argmax(gumbel[:, t] + logits, dim=-1)
        newc = xf[rows, i]
        take = (t < kv)[:, None]
        centers[:, t] = torch.where(take, newc, centers[:, t])
        d2 = torch.sum((xf - newc[:, None]) ** 2, dim=-1)
        mind2 = torch.where(take, torch.minimum(mind2, d2), mind2)
    center_mask = torch.arange(k, device=dev)[None, :] < kv[:, None]
    return centers.to(x.dtype), center_mask


class LocalReducer:
    """Reduction strategy for a server that owns the full point set:
    argmax, row fetch and sum are plain local operations."""

    def argmax(self, vals: torch.Tensor) -> torch.Tensor:
        return torch.argmax(vals).to(torch.int32)

    def fetch_row(self, points: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
        return points[idx.long()]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x


def maxmin_grow(pf: torch.Tensor, valid: torch.Tensor, chosen: torch.Tensor,
                mind2: torch.Tensor, count0: torch.Tensor, k: int,
                reducer=None) -> torch.Tensor:
    """The greedy farthest-point growth loop (steps 4-6 of Algorithm 2).
    ``chosen`` holds the selected indices in slots < count0; ``mind2``
    the distance of every point to the current set (-inf for invalid
    points). Ties go to the smallest index."""
    reducer = reducer or LocalReducer()
    p2 = torch.sum(pf * pf, dim=1)
    neg_inf = torch.full_like(mind2, float("-inf"))
    chosen = chosen.clone()
    for t in range(k):
        grow = t >= count0
        cand = reducer.argmax(mind2)
        chosen[t] = torch.where(grow, cand, chosen[t])
        c = reducer.fetch_row(pf, cand)
        nd = torch.clamp_min(p2 - 2.0 * (pf @ c) + torch.sum(c * c), 0.0)
        nd = torch.where(valid, nd, neg_inf)
        mind2 = torch.where(grow, torch.minimum(mind2, nd), mind2)
    return chosen


def maxmin_seed(points: torch.Tensor, valid: torch.Tensor,
                init_sel: torch.Tensor, k: int) -> torch.Tensor:
    """Farthest-point (max-min) seeding, steps 2-6 of Algorithm 2: start
    from the already-selected set ``init_sel`` (one device's centers)
    and add the point farthest from the set until it holds k.

    points: (m, d); valid / init_sel: (m,) bool. Returns (k,) int32."""
    pf = points.float()
    dev = pf.device
    sel = init_sel & valid
    order = torch.sort(torch.where(sel, 0, 1).to(torch.int32),
                       stable=True).indices[:k]
    count0 = torch.sum(sel).to(torch.int32)
    slots = torch.arange(k, device=dev)
    chosen = torch.where(slots < count0, order.to(torch.int32),
                         torch.full((k,), -1, dtype=torch.int32, device=dev))
    init_pts = pf[order]
    init_ok = sel[order]
    d2 = ops.pairwise_sq_dists(pf, init_pts)
    d2 = torch.where(init_ok[None, :], d2, torch.full_like(d2, float("inf")))
    mind2 = torch.amin(d2, dim=1)
    mind2 = torch.where(valid, mind2, torch.full_like(mind2, float("-inf")))
    return maxmin_grow(pf, valid, chosen, mind2, count0, k)
