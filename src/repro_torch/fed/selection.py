"""Client selection (Section 4.2.2, Figure 4): random sampling, pow-d
(power-of-choice, Cho et al. 2020), and k-FED-filtered pow-d, which drops
redundant same-cluster candidates before the loss-based pick.
Counterpart of ``repro/fed/selection.py``: numpy on the host, the same
picks from the same ``np.random.Generator``."""
from __future__ import annotations

import numpy as np


def random_selection(rng: np.random.Generator, Z: int, m: int):
    return rng.choice(Z, size=min(m, Z), replace=False)


def pow_d(rng: np.random.Generator, losses: np.ndarray, m: int, d: int):
    """Sample d candidates uniformly, keep the m with largest local loss."""
    Z = len(losses)
    cand = rng.choice(Z, size=min(d, Z), replace=False)
    order = cand[np.argsort(-losses[cand])]
    return order[:m]


def kfed_pow_d(rng: np.random.Generator, losses: np.ndarray,
               clusters: np.ndarray, m: int, d: int):
    """pow-d with k-FED cluster filtering: among the d candidates, keep at
    most one device per k-FED cluster (the highest-loss one), then the
    top-m by loss; refill from remaining candidates if short."""
    Z = len(losses)
    cand = rng.choice(Z, size=min(d, Z), replace=False)
    order = cand[np.argsort(-losses[cand])]
    seen, picked = set(), []
    for z in order:
        c = int(clusters[z])
        if c not in seen:
            seen.add(c)
            picked.append(z)
        if len(picked) == m:
            return np.asarray(picked)
    for z in order:          # refill with duplicates if clusters < m
        if z not in picked:
            picked.append(z)
        if len(picked) == m:
            break
    return np.asarray(picked[:m])
