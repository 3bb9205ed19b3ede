"""The paper's Figures 2 and 3 on the port (counterparts of
``benchmarks/bench_fig2_heterogeneity.py`` and
``benchmarks/bench_fig3_communication.py``, with their sizes, seeds and
draws in the same order).

* Figure 2, the benefit of heterogeneity: the k-means cost of k-FED on
  structured partitions (k' clusters a device) against IID ones, each
  over the oracle's (centralised k-means) cost,
  ``(phi(k') - phi*) / (phi(k) - phi*)`` (below 1 is a win), on the
  FEMNIST-like and Shakespeare-like proxies.
* Figure 3, communication: one k-FED round against 25 rounds of
  distributed Lloyd (centralised Lloyd over every device's points, which
  computes the same), as a cost ratio and in the exact bytes each
  protocol moves.

The random draws come from ``GumbelSource`` objects (``oracle_source``,
``lloyd_source``) and the rounds' keys from ``round_key(seed, Z)``, so a
caller can hand in the JAX package's draws; by default they are the
port's own, keyed by the benchmarks' seeds.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.kfed import kmeans_cost_of_labels
from repro_torch.core.lloyd import (assign_points, kmeans_pp_init, lloyd,
                                    update_centers)
from repro_torch.data.gaussian import structured_devices
from repro_torch.data.partition import partition_iid, partition_structured
from repro_torch.data.synthetic_tasks import femnist_like, shakespeare_like
from repro_torch.fed.api import FederationPlan, Session
from repro_torch.utils.prng import GumbelSource

__all__ = ["fig2", "fig2_dataset", "fig2_datasets", "fig3", "fig3_row",
           "fig3_settings", "lloyd_rounds"]


def _own_key(seed: int, Z: int):
    return seed


def _seed_draws(source: GumbelSource, x: torch.Tensor, k: int):
    """k-means++ on the rows of x (n, d) with id 0's draws of
    ``source``: (centers (k, d), center_mask (k,))."""
    g = source.draw([0], k, x.shape[0], x.device)
    c, cm = kmeans_pp_init(g, x[None], k)
    return c[0], cm[0]


def _oracle(source: GumbelSource, x: torch.Tensor, k: int):
    """The centralised clustering, the paper's oracle T: (labels, phi*)."""
    init, cm = _seed_draws(source, x, k)
    res = lloyd(x, init, center_mask=cm)
    return res.assign, float(kmeans_cost_of_labels(x, res.assign, k))


def fig2_dataset(name: str, xs, ys, k: int, k_primes, Z: int, *,
                 device="cuda", seeds: int = 2,
                 oracle_source: Optional[GumbelSource] = None,
                 round_key: Callable = _own_key) -> List[dict]:
    """One dataset's rows of Figure 2: for each k', ``seeds`` structured
    and IID partitions (one ``np.random.default_rng(0)`` across them),
    each clustered by one k-FED round keyed by ``round_key(10 + s, Z)``.
    Each row holds the costs, the per-seed ratios and their mean."""
    dev = torch.device(device)
    X = np.concatenate(xs).astype(np.float32)
    orc_lbl, phi_star = _oracle(oracle_source or GumbelSource(0),
                                torch.as_tensor(X, device=dev), k)
    orc_lbl = orc_lbl.cpu().numpy()
    rng = np.random.default_rng(0)

    def cost_of(part, kp_eff, s):
        plan = FederationPlan(k=k, k_prime=kp_eff,
                              d=int(part.data.shape[-1]), device=str(dev))
        data = torch.as_tensor(part.data, device=dev)
        mask = torch.as_tensor(part.point_mask, device=dev)
        res = Session(plan).run(round_key(10 + s, part.data.shape[0]),
                                data, k_valid=part.k_valid, point_mask=mask)
        lbl = torch.where(mask, res.labels, torch.full_like(res.labels, -1))
        return float(kmeans_cost_of_labels(data, lbl, k))

    rows = []
    for kp in k_primes:
        t0 = time.perf_counter()
        costs, ratios = [], []
        for s in range(seeds):
            st = partition_structured(rng, X, orc_lbl, k=k, Z=Z, k_prime=kp)
            ii = partition_iid(rng, X, orc_lbl, k=k, Z=Z)
            phi_kp = cost_of(st, kp, s)
            phi_k = cost_of(ii, min(k, int(ii.k_valid.max())), s)
            costs.append((phi_kp, phi_k))
            ratios.append((phi_kp - phi_star) / max(phi_k - phi_star, 1e-9))
        rows.append({"name": f"fig2_{name}_kprime{kp}", "phi_star": phi_star,
                     "costs": costs, "ratios": ratios,
                     "ratio": float(np.mean(ratios)),
                     "wall_s": time.perf_counter() - t0})
    return rows


def fig2_datasets(full: bool):
    """Figure 2's two proxies as the benchmark draws them:
    [(name, xs, ys, k, k_primes, Z)]."""
    rng = np.random.default_rng(1)
    Z = 60 if full else 24
    xs, ys, _ = femnist_like(rng, Z=Z, d=64 if full else 32,
                             mean_n=80 if full else 40)
    out = [("femnist", xs, ys, 10, [1, 2, 3, 5] if full else [1, 2, 3], Z)]
    xs, ys, _ = shakespeare_like(rng, Z=Z, n_per_dev=60)
    out.append(("shakespeare", xs, ys, 8, [1, 2], Z))
    return out


def fig2(full: bool = False, device="cuda", **kw) -> List[dict]:
    """Every row of Figure 2 (``kw``: see :func:`fig2_dataset`)."""
    return [row for name, xs, ys, k, kps, Z in fig2_datasets(full)
            for row in fig2_dataset(name, xs, ys, k, kps, Z, device=device,
                                    **kw)]


def fig3_settings(full: bool):
    """(k, d, k', m0, points a component a device, Lloyd rounds)."""
    k, d, kp, m0 = (36, 60, 6, 4) if full else (16, 40, 4, 3)
    return k, d, kp, m0, 40, 25


def lloyd_rounds(source: GumbelSource, X: torch.Tensor, k: int,
                 iters: int) -> torch.Tensor:
    """Distributed Lloyd simulated centrally (the assignment is
    embarrassingly parallel and the update one all-reduce a round, so
    the result is the same): k-means++ on a strided sample of at most
    32k rows of X (N, d), ``iters`` rounds, then the final assignment
    (N,)."""
    N = X.shape[0]
    sub = X[::max(1, N // (32 * k))][:32 * k]
    c, _ = _seed_draws(source, sub, k)
    for _ in range(iters):
        a, _ = assign_points(X, c)
        c, _ = update_centers(X, a, k, c)
    return assign_points(X, c)[0]


def fig3_row(data, k: int, kp: int, s: int, *, device="cuda",
             rounds: int = 25, round_key: Callable = _own_key,
             lloyd_source: Optional[GumbelSource] = None) -> dict:
    """One row of Figure 3 for the devices' points ``data`` (Z, n, d):
    the k-FED round keyed by ``round_key(7 + s, Z)``, distributed Lloyd
    seeded from ``lloyd_source`` (default ``GumbelSource(17 + s)``), the
    cost ratio and the f32 bytes each protocol moves (k-FED: each
    device's k' centers once, plus tau's broadcast; Lloyd: every round,
    each device's (k, d) sums and k counts)."""
    dev = torch.device(device)
    x = torch.as_tensor(data, device=dev)
    Z, _, d = x.shape
    flat = x.reshape(-1, d)
    t0 = time.perf_counter()
    out = Session(FederationPlan(k=k, k_prime=kp, d=d, device=str(dev))
                  ).run(round_key(7 + s, Z), x)
    phi_kfed = float(kmeans_cost_of_labels(flat, out.labels.reshape(-1), k))
    kfed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bl = lloyd_rounds(lloyd_source or GumbelSource(17 + s), flat, k, rounds)
    phi_lloyd = float(kmeans_cost_of_labels(flat, bl, k))
    lloyd_s = time.perf_counter() - t0
    kfed_bytes = Z * kp * d * 4 + k * d * 4
    lloyd_bytes = rounds * Z * (k * d + k) * 4
    return {"name": f"fig3_kprime{kp}", "Z": Z, "phi_kfed": phi_kfed,
            "phi_lloyd": phi_lloyd,
            "ratio": phi_kfed / max(phi_lloyd, 1e-9),
            "bytes_kfed": kfed_bytes, "bytes_lloyd": lloyd_bytes,
            "kfed_s": kfed_s, "lloyd_s": lloyd_s}


def fig3(full: bool = False, device="cuda", **kw) -> List[dict]:
    """Every row of Figure 3: k' in {1, k'/2, k'}, the devices drawn by
    ``structured_devices`` from seed s (``kw``: see :func:`fig3_row`)."""
    k, d, kp, m0, n_per, rounds = fig3_settings(full)
    rows = []
    for s, kp_i in enumerate([1, kp // 2, kp]):
        kp_eff = max(1, kp_i)
        fm = structured_devices(s, k=k, d=d, k_prime=kp_eff,
                                m0=m0 * (kp // kp_eff),
                                n_per_comp_dev=n_per, sep=25.0)
        rows.append(fig3_row(fm.data, k, kp_eff, s, device=device,
                             rounds=rounds, **kw))
    return rows
