"""Algorithm 1 — the local (per-device) k-means solve of k-FED
(counterpart of ``repro/core/local_kmeans.py``).

  1. Project the device data onto the span of its top-k^(z) right
     singular vectors.
  2. k-means++ seeding and a few Lloyd steps on the projected data.
  3. The 1/3-margin core sets
        S_r = { i : ||Ahat_i - nu_r|| <= (1/3) ||Ahat_i - nu_s||  forall s }
     and their means theta_r on the original data.
  4. Lloyd on the original data until convergence.

Every function here takes the device axis written out: data (B, n, d),
``k_valid`` (B,), ``point_mask`` (B, n). So :func:`local_prepare` and
:func:`local_kmeans` are also the JAX package's ``batched_*`` forms.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.lloyd import kmeans_pp_init, lloyd, update_centers
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MASKED_DIST


def _k_valid(k_valid, B: int, k_max: int, device) -> torch.Tensor:
    if k_valid is None:
        return torch.full((B,), k_max, dtype=torch.int32, device=device)
    return torch.as_tensor(k_valid, dtype=torch.int32,
                           device=device).reshape(B)


def _point_mask(point_mask, shape, device) -> torch.Tensor:
    if point_mask is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return torch.as_tensor(point_mask, dtype=torch.bool, device=device)


def project_top_k(A: torch.Tensor, k_valid, k_max: int,
                  point_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projection of the rows of A (B, n, d) onto the top-k_valid right
    singular subspace of the masked rows (exact SVD)."""
    B, n, d = A.shape
    Af = A.float()
    pm = _point_mask(point_mask, (B, n), A.device)
    Am = Af * pm.unsqueeze(-1)
    Vt = torch.linalg.svd(Am, full_matrices=False).Vh   # (B, min(n, d), d)
    rows = min(k_max, Vt.shape[-2])
    V = torch.zeros((B, k_max, d), dtype=torch.float32, device=A.device)
    V[:, :rows] = Vt[:, :rows]
    kv = _k_valid(k_valid, B, k_max, A.device)
    rmask = torch.arange(k_max, device=A.device)[None, :] < kv[:, None]
    V = V * rmask.unsqueeze(-1)
    return ((Af @ V.transpose(-1, -2)) @ V).to(A.dtype)


def subspace_project(A: torch.Tensor, k_valid, k_max: int,
                     point_mask: Optional[torch.Tensor] = None,
                     iters: int = 12) -> torch.Tensor:
    """Block power (subspace) iteration on A^T A: the matmul-only
    variant of :func:`project_top_k`."""
    B, n, d = A.shape
    Af = A.float()
    pm = _point_mask(point_mask, (B, n), A.device)
    Am = Af * pm.unsqueeze(-1)
    i = torch.arange(d, dtype=torch.float32, device=A.device)[:, None]
    j = torch.arange(k_max, dtype=torch.float32, device=A.device)[None, :]
    V0 = torch.cos(0.37 * (i + 1.0) * (j + 1.0)) + 1e-3 * (i - j)
    V = torch.linalg.qr(V0).Q.expand(B, d, k_max)
    for _ in range(iters):
        W = Am.transpose(-1, -2) @ (Am @ V)
        V = torch.linalg.qr(W).Q
    kv = _k_valid(k_valid, B, k_max, A.device)
    rmask = torch.arange(k_max, device=A.device)[None, :] < kv[:, None]
    V = V * rmask.unsqueeze(-2)
    return ((Af @ V) @ V.transpose(-1, -2)).to(A.dtype)


class LocalKMeansResult(NamedTuple):
    centers: torch.Tensor       # (B, k_max, d)  Theta^(z)
    center_mask: torch.Tensor   # (B, k_max) bool
    assign: torch.Tensor        # (B, n) int32 local cluster ids, -1 masked
    core_counts: torch.Tensor   # (B, k_max) |S_r| from the 1/3-margin step


class LocalPrepared(NamedTuple):
    """Steps 1-3 of Algorithm 1: the core-set means that the step-4
    convergence loop starts from."""
    theta: torch.Tensor         # (B, k_max, d) f32 core-set means
    center_mask: torch.Tensor   # (B, k_max) bool
    core_counts: torch.Tensor   # (B, k_max) |S_r|


def split_local_kw(local_kw: dict):
    """Split ``local_kmeans`` kwargs into those of :func:`local_prepare`
    (steps 1-3) and the step-4 ``max_iters`` bound."""
    kw = dict(local_kw)
    return kw, int(kw.pop("max_iters", 100))


def core_sets(A: torch.Tensor, Ahat: torch.Tensor, nu: torch.Tensor,
              center_mask: torch.Tensor, point_mask: torch.Tensor,
              k_max: int):
    """Step 3 of Algorithm 1: the 1/3-margin core sets of the projected
    points ``Ahat`` around ``nu`` (distances, not squared distances), and
    their means on the original data ``A``. Returns (theta (B, k_max, d)
    f32, core_counts (B, k_max) f32)."""
    d2 = ops.pairwise_sq_dists(Ahat, nu)
    d2 = torch.where(center_mask.unsqueeze(-2), d2,
                     torch.full_like(d2, MASKED_DIST))
    dd = torch.sqrt(d2)
    r = torch.argmin(dd, dim=-1)
    dmin = torch.amin(dd, dim=-1)
    mine = torch.nn.functional.one_hot(r, k_max).bool()
    second = torch.amin(torch.where(mine, float("inf"), dd), dim=-1)
    in_core = (dmin <= second / 3.0) & point_mask
    core_assign = torch.where(in_core, r.to(torch.int32),
                              torch.full_like(r, -1, dtype=torch.int32))
    return update_centers(A.float(), core_assign, k_max, nu.float())


def local_prepare(gumbel: torch.Tensor, A: torch.Tensor, *, k_max: int,
                  k_valid=None, point_mask=None, approx_iters: int = 8,
                  use_subspace_iteration: bool = False) -> LocalPrepared:
    """Algorithm 1 steps 1-3 on a batch of devices: spectral projection,
    k-means++ + approximate Lloyd on the projected data, and the
    1/3-margin core-set means. gumbel: (B, k_max, n); A: (B, n, d)."""
    B, n, _ = A.shape
    kv = _k_valid(k_valid, B, k_max, A.device)
    pm = _point_mask(point_mask, (B, n), A.device)

    proj = subspace_project if use_subspace_iteration else project_top_k
    Ahat = proj(A, kv, k_max, point_mask=pm)

    nu, cmask = kmeans_pp_init(gumbel, Ahat, k_max, point_mask=pm,
                               k_valid=kv)
    nu = lloyd(Ahat, nu, center_mask=cmask, point_mask=pm,
               max_iters=approx_iters).centers

    theta, core_counts = core_sets(A, Ahat, nu, cmask, pm, k_max)
    return LocalPrepared(theta, cmask, core_counts)


def local_kmeans(gumbel: torch.Tensor, A: torch.Tensor, *, k_max: int,
                 k_valid=None, point_mask=None, approx_iters: int = 8,
                 max_iters: int = 100,
                 use_subspace_iteration: bool = False) -> LocalKMeansResult:
    """Algorithm 1 on a batch of devices. gumbel: (B, k_max, n);
    A: (B, n, d)."""
    B, n, _ = A.shape
    pm = _point_mask(point_mask, (B, n), A.device)
    prep = local_prepare(gumbel, A, k_max=k_max, k_valid=k_valid,
                         point_mask=pm, approx_iters=approx_iters,
                         use_subspace_iteration=use_subspace_iteration)
    res = lloyd(A.float(), prep.theta, center_mask=prep.center_mask,
                point_mask=pm, max_iters=max_iters)
    return LocalKMeansResult(res.centers.to(A.dtype), prep.center_mask,
                             res.assign, prep.core_counts)

