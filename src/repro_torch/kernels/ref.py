"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

These are the reference semantics: on a CPU tensor ``kernels/ops.py``
runs them, and every CUDA kernel in ``kernels/csrc`` is held against
them on the card. Each function takes an optional leading batch axis, so
a batched caller makes one call instead of one per batch entry.
"""
from __future__ import annotations

from typing import Optional

import torch

MASKED_DIST = 1e30  # additive "infinity" that survives f32 matmul paths

SOLVE_ATTACH_DTYPES = ("f32", "bf16")


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. x: (..., n, d), c: (..., k, d) or a
    shared (k, d) -> (..., n, k), clamped at 0."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    d = x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2.unsqueeze(-2)
    return torch.clamp_min(d, 0.0)


def assign_argmin(x: torch.Tensor, c: torch.Tensor,
                  c_mask: Optional[torch.Tensor] = None):
    """Nearest-center assignment. Returns (idx (..., n) int32,
    min_sq_dist (..., n) f32). A masked center's distance is exactly
    ``MASKED_DIST``; with every center masked, idx=0 and val=1e30. Ties
    go to the smallest center index."""
    d = pairwise_sq_dists(x, c)
    if c_mask is not None:
        d = torch.where(c_mask.unsqueeze(-2), d,
                        torch.full_like(d, MASKED_DIST))
    # torch.argmin returns the first occurrence, like jnp.argmin.
    return torch.argmin(d, dim=-1).to(torch.int32), torch.amin(d, dim=-1)


def kmeans_update(x: torch.Tensor, assign: torch.Tensor, k: int,
                  weights: Optional[torch.Tensor] = None):
    """Per-cluster sums and counts. ``assign`` entries equal to -1
    contribute nothing. x: (..., n, d), assign: (..., n) ->
    (sums (..., k, d) f32, counts (..., k) f32)."""
    cols = torch.arange(k, device=assign.device, dtype=assign.dtype)
    oh = (assign.unsqueeze(-1) == cols).float()
    if weights is not None:
        oh = oh * weights.float().unsqueeze(-1)
    sums = oh.transpose(-1, -2) @ x.float()
    counts = torch.sum(oh, dim=-2)
    return sums, counts


def store_dtype(dtype: str) -> torch.dtype:
    if dtype not in SOLVE_ATTACH_DTYPES:
        raise ValueError(f"dtype={dtype!r} is invalid: accepted values "
                         f"are {list(SOLVE_ATTACH_DTYPES)}")
    return torch.float32 if dtype == "f32" else torch.bfloat16


def solve_attach(x: torch.Tensor, centers0: torch.Tensor,
                 tau: torch.Tensor,
                 center_mask: Optional[torch.Tensor] = None,
                 point_mask: Optional[torch.Tensor] = None,
                 *, max_iters: int = 100, dtype: str = "f32"):
    """The fused serve step: per request, the bounded Lloyd loop until
    the assignment is stable, the Theorem 3.2 attach of the converged
    centers against ``tau``, and the Definition 3.3 induced labels.

    x: (B, n, d); centers0: (B, k', d); tau: (k, d) shared;
    center_mask: (B, k') bool; point_mask: (B, n) bool. Returns
    (labels (B, n) i32, min_sq_dist (B, n) f32, centers (B, k', d) f32,
    center_labels (B, k') i32). ``dtype="bf16"`` stores x / centers /
    tau in bfloat16 between iterations and accumulates in f32.

    Each request's loop is its own: a request whose assignment is stable
    is frozen while the others go on, as under ``vmap`` of a while loop.
    """
    store = store_dtype(dtype)
    B, n, _ = x.shape
    kp = centers0.shape[1]
    dev = x.device
    cm = (torch.ones((B, kp), dtype=torch.bool, device=dev)
          if center_mask is None else center_mask)
    pm = (torch.ones((B, n), dtype=torch.bool, device=dev)
          if point_mask is None else point_mask)
    xs = x.to(store)
    taus = tau.to(store)

    def assign(centers):
        idx, mind = assign_argmin(xs, centers, cm)
        return (torch.where(pm, idx, torch.full_like(idx, -1)),
                torch.where(pm, mind, torch.zeros_like(mind)))

    centers = centers0.to(store)
    prev = torch.full((B, n), -2, dtype=torch.int32, device=dev)
    it = 0
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    while it < max_iters and not bool(done.all()):
        a, _ = assign(centers)
        sums, cnt = kmeans_update(xs, a, kp)
        new = sums / torch.clamp_min(cnt, 1.0).unsqueeze(-1)
        new = torch.where((cnt > 0).unsqueeze(-1), new, centers.float())
        live = ~done
        centers = torch.where(live[:, None, None], new.to(store), centers)
        done = done | (live & torch.all(a == prev, dim=-1))
        prev = a
        it += 1
    a, mind = assign(centers)
    ctr, _ = assign_argmin(centers, taus)
    ctr = torch.where(cm, ctr, torch.full_like(ctr, -1))
    safe = torch.clamp(a, 0, kp - 1).long()
    lbl = torch.gather(ctr, 1, safe)
    lbl = torch.where(a >= 0, lbl, torch.full_like(lbl, -1))
    return lbl, mind, centers.float(), ctr
