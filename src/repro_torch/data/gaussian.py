"""Synthetic mixture-of-Gaussians federated data, Section 4.1 of the
paper (counterpart of ``repro/data/gaussian.py``, in numpy).

k components; groups G_i of k' components each; each group's data split
across m0 devices, so every device holds points of exactly k' components,
devices in one group share their component set and devices of different
groups share none (Definition 3.2 heterogeneity). Everything is drawn
from an explicit seed with numpy, so the same arrays can be handed to
both packages.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


def make_mixture_means(rng: np.random.Generator, k: int, d: int, *,
                       sep: float) -> np.ndarray:
    """k means in R^d whose minimum pairwise distance is ``sep``
    (rescaled random Gaussian placement). (k, d) f32."""
    mu = rng.standard_normal((k, d)).astype(np.float32)
    d2 = np.sum((mu[:, None] - mu[None, :]) ** 2, -1) + np.eye(k) * 1e30
    min_sep = np.sqrt(np.min(d2))
    return (mu * (sep / max(min_sep, 1e-12))).astype(np.float32)


class FederatedMixture(NamedTuple):
    data: np.ndarray             # (Z, n, d) f32
    labels: np.ndarray           # (Z, n) target cluster ids
    k_valid: np.ndarray          # (Z,) = k' everywhere here
    presence: np.ndarray         # (Z, k) bool
    means: np.ndarray            # (k, d)
    group_of_device: np.ndarray  # (Z,)


def structured_devices(seed: int, *, k: int, d: int, k_prime: int, m0: int,
                       n_per_comp_dev: int, sep: float,
                       sigma: float = 1.0) -> FederatedMixture:
    """The paper's G_i construction: Z = (k / k') * m0 devices; device z
    of group g holds ``n_per_comp_dev`` points of each of the k'
    components of G_g."""
    if k % k_prime:
        raise ValueError(f"k={k} must be a multiple of k_prime={k_prime}")
    rng = np.random.default_rng(seed)
    n_groups = k // k_prime
    Z = n_groups * m0
    n = k_prime * n_per_comp_dev
    means = make_mixture_means(rng, k, d, sep=sep)
    group = np.repeat(np.arange(n_groups), m0)
    comp_in_dev = np.tile(np.repeat(np.arange(k_prime), n_per_comp_dev),
                          (Z, 1))
    labels = group[:, None] * k_prime + comp_in_dev
    noise = rng.standard_normal((Z, n, d)).astype(np.float32) * sigma
    data = (means[labels] + noise).astype(np.float32)
    presence = np.zeros((Z, k), bool)
    presence[np.arange(Z)[:, None], labels] = True
    k_valid = np.full((Z,), k_prime, np.int32)
    return FederatedMixture(data, labels, k_valid, presence, means, group)


def late_device_stream(means, k_prime: int, requests: int, seed: int, *,
                       n_range: Tuple[int, int] = (16, 400),
                       kv_min: int = 1, sigma: float = 1.0):
    """Synthetic post-round attach requests: each late device holds a
    random component subset of size k^(z) in [kv_min, k_prime] and a
    point count drawn from ``n_range``. Returns
    [(data (n, d) f32, labels (n,), k^(z))]."""
    mu = np.asarray(means)
    k, d = mu.shape
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(requests):
        kv = int(rng.integers(kv_min, k_prime + 1))
        comps = rng.choice(k, kv, replace=False)
        n = int(rng.integers(*n_range))
        lab = rng.choice(comps, n)
        data = (mu[lab] + rng.normal(size=(n, d)) * sigma).astype(np.float32)
        out.append((data, lab, kv))
    return out
