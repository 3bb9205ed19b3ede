"""Separation and heterogeneity analysis, Section 3 of the paper
(counterpart of ``repro/core/separation.py``).

The deterministic quantities the theory is stated in:

  ||A - C||                  spectral norm of the data-minus-means matrix
  tilde_Delta_r = sqrt(k) ||A-C|| / sqrt(n_r)      (eq. 2, centralized)
  Delta_r       = k'      ||A-C|| / sqrt(n_r)      (eq. 4)
  lambda        = sqrt(k')||A-C|| / sqrt(n_min)    (eq. 4)

plus active/inactive pairs (Definition 3.4), the separation each needs
(Definition 3.5, Theorem 3.1), the proximity condition (Definition 3.1)
and the c_rs spectra of the paper's Figure 1. Cluster means go through
``ops.kmeans_update`` (the kernel on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


def spectral_norm(M: torch.Tensor, iters: int = 100) -> torch.Tensor:
    """||M|| by power iteration on M^T M from the reference's
    deterministic start vector, for ``iters`` steps."""
    Mf = M.float()
    d = Mf.shape[1]
    v = 1.0 + 1e-3 * torch.arange(d, dtype=torch.float32, device=M.device)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = Mf.T @ (Mf @ v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return torch.linalg.norm(Mf @ v)


def cluster_means(A: torch.Tensor, labels: torch.Tensor, k: int):
    """Returns (means (k, d), sizes (k,)); labels -1 are left out."""
    sums, cnt = ops.kmeans_update(A.float(), labels, k)
    return sums / torch.clamp(cnt, min=1.0)[:, None], cnt


def a_minus_c_norm(A: torch.Tensor, labels: torch.Tensor,
                   k: int) -> torch.Tensor:
    """||A - C|| where C_i = mu(T_{c(A_i)})."""
    mu, _ = cluster_means(A, labels, k)
    C = mu[torch.clamp(labels, 0, k - 1).long()]
    diff = (A.float() - C) * (labels >= 0)[:, None]
    return spectral_norm(diff)


def deltas(norm_ac, sizes, k_prime: int):
    """Delta_r (eq. 4) for every cluster."""
    return k_prime * norm_ac / torch.sqrt(torch.clamp(sizes, min=1.0))


def tilde_deltas(norm_ac, sizes, k: int):
    """tilde_Delta_r (eq. 2), the centralized analogue."""
    return float(k) ** 0.5 * norm_ac / torch.sqrt(torch.clamp(sizes,
                                                              min=1.0))


def lam(norm_ac, n_min_device, k_prime: int):
    """lambda (eq. 4); n_min_device = min_z n^(z)."""
    n = torch.as_tensor(n_min_device, dtype=torch.float32,
                        device=norm_ac.device)
    return float(k_prime) ** 0.5 * norm_ac / torch.sqrt(
        torch.clamp(n, min=1.0))


def active_pairs(presence: torch.Tensor) -> torch.Tensor:
    """Definition 3.4. presence: (Z, k) bool, cluster r has points on
    device z. Returns (k, k) bool, True where a device holds r and s."""
    p = presence.float()
    co = torch.einsum("zr,zs->rs", p, p)
    k = presence.shape[1]
    return (co > 0) & ~torch.eye(k, dtype=torch.bool,
                                 device=presence.device)


class SeparationReport(NamedTuple):
    norm_ac: torch.Tensor          # ||A - C||
    sizes: torch.Tensor            # (k,) n_r
    means: torch.Tensor            # (k, d)
    delta: torch.Tensor            # (k,) Delta_r
    lam: torch.Tensor              # () lambda
    c_rs: torch.Tensor             # (k, k) ||mu_r-mu_s|| / (sqrt(m0)(D_r+D_s))
    active: torch.Tensor           # (k, k) bool
    active_satisfied: torch.Tensor     # fraction of active pairs, c_rs >= c
    inactive_satisfied: torch.Tensor   # fraction of inactive pairs with
                                       # ||mu_r-mu_s|| >= 10 sqrt(m0) lambda


def separation_report(A: torch.Tensor, labels: torch.Tensor, k: int,
                      presence: torch.Tensor, n_min_device, *,
                      k_prime: int, m0: float,
                      c: float) -> SeparationReport:
    mu, sizes = cluster_means(A, labels, k)
    norm_ac = a_minus_c_norm(A, labels, k)
    D = deltas(norm_ac, sizes, k_prime)
    lm = lam(norm_ac, n_min_device, k_prime)
    dmu = torch.sqrt(torch.clamp(ops.pairwise_sq_dists(mu, mu), min=0.0))
    denom = float(m0) ** 0.5 * (D[:, None] + D[None, :])
    c_rs = dmu / torch.clamp(denom, min=1e-30)
    act = active_pairs(presence)
    off = ~torch.eye(k, dtype=torch.bool, device=act.device)
    inact = off & ~act
    act_ok = torch.sum((c_rs >= c) & act) / torch.clamp(torch.sum(act),
                                                         min=1)
    inact_ok = torch.sum((dmu >= 10.0 * float(m0) ** 0.5 * lm) & inact) / \
        torch.clamp(torch.sum(inact), min=1)
    return SeparationReport(norm_ac, sizes, mu, D, lm, c_rs, act,
                            act_ok, inact_ok)


def proximity_satisfied(A: torch.Tensor, labels: torch.Tensor, k: int,
                        norm_ac=None) -> torch.Tensor:
    """Definition 3.1 per point: for i in T_s and every r != s, the
    projection of A_i on the mu_r -> mu_s line must favour mu_s by
    (1/sqrt(n_r) + 1/sqrt(n_s)) ||A - C||. Returns (n,) bool."""
    Af = A.float()
    mu, sizes = cluster_means(A, labels, k)
    if norm_ac is None:
        norm_ac = a_minus_c_norm(A, labels, k)
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp(sizes, min=1.0))
    s = torch.clamp(labels, 0, k - 1).long()           # (n,)
    mu_s = mu[s]                                       # (n, d)
    diff_centers = mu[None, :, :] - mu_s[:, None, :]   # (n, k, d)
    sep = torch.linalg.norm(diff_centers, dim=-1)      # (n, k)
    u = diff_centers / torch.clamp(sep, min=1e-30)[..., None]
    t = torch.einsum("nd,nkd->nk", Af - mu_s, u)       # projection
    margin = torch.abs(t - sep) - torch.abs(t)
    thresh = (inv_sqrt[None, :] + inv_sqrt[s][:, None]) * norm_ac
    same = torch.nn.functional.one_hot(s, k).bool()
    ok_rs = (margin >= thresh) | same | (sizes[None, :] == 0)
    return torch.all(ok_rs, dim=1) & (labels >= 0)
