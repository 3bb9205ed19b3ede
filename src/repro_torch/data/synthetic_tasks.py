"""Synthetic structural proxies for the paper's real-data experiments
(counterpart of ``repro/data/synthetic_tasks.py``; numpy, the same draws
from the same ``np.random.Generator``). LEAF and MNIST are not used
offline (DESIGN.md §7).

* rotation_tasks  — Table 2 proxy: k rotation clusters of a 10-class
  prototype classification problem (the rotated-MNIST construction with
  synthetic prototypes instead of MNIST digits).
* femnist_like    — Figure 2/4 proxy: 62-class prototype features,
  <=2 classes per device, power-law device sizes.
* shakespeare_like— Figure 2 proxy: per-role character-histogram features
  with role clusters.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SupervisedFed(NamedTuple):
    x: np.ndarray           # (Z, n, d)
    y: np.ndarray           # (Z, n) class labels
    cluster: np.ndarray     # (Z,) true device cluster (rotation id)
    point_mask: np.ndarray  # (Z, n)


def _rotate_pairs(x, angle):
    """Rotate feature pairs (2D planes) by ``angle`` — the d-dimensional
    analogue of image rotation used to build the k=4 task clusters."""
    d = x.shape[-1]
    c, s = np.cos(angle), np.sin(angle)
    y = x.copy()
    y[..., 0::2] = c * x[..., 0::2] - s * x[..., 1::2]
    y[..., 1::2] = s * x[..., 0::2] + c * x[..., 1::2]
    return y


def rotation_tasks(rng: np.random.Generator, *, Z: int, n_per_dev: int,
                   d: int = 32, n_classes: int = 10, k: int = 4,
                   sigma: float = 0.35, k_prime: int = 1) -> SupervisedFed:
    """k rotation clusters (0/90/180/270 degrees for k=4). Each device
    draws its data from k_prime clusters (k'=1 reproduces the IFCA setup;
    k'=2 the paper's harder mixed-device rows)."""
    protos = rng.normal(size=(n_classes, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    angles = [2 * np.pi * j / k for j in range(k)]
    x = np.zeros((Z, n_per_dev, d), np.float32)
    y = np.zeros((Z, n_per_dev), np.int32)
    cluster = np.zeros((Z,), np.int32)
    for z in range(Z):
        devclusters = rng.choice(k, size=k_prime, replace=False)
        cluster[z] = devclusters[0]
        part = np.array_split(np.arange(n_per_dev), k_prime)
        for cj, idx in zip(devclusters, part):
            cls = rng.integers(0, n_classes, size=len(idx))
            base = protos[cls] + sigma * rng.normal(
                size=(len(idx), d)).astype(np.float32)
            x[z, idx] = _rotate_pairs(base, angles[cj])
            y[z, idx] = cls
    return SupervisedFed(x, y, cluster,
                         np.ones((Z, n_per_dev), bool))


def femnist_like(rng: np.random.Generator, *, Z: int = 100, d: int = 64,
                 n_classes: int = 10, classes_per_dev: int = 2,
                 mean_n: int = 80, power: float = 1.5):
    """Class-prototype gaussians; 2 classes/device; power-law sizes
    (Appendix B.1 structure). Returns (X list, y list) per device plus the
    packed DevicePartition-style arrays via data.partition._pack."""
    protos = 3.0 * rng.normal(size=(n_classes, d)).astype(np.float32)
    sizes = np.maximum(8, (mean_n * (rng.pareto(power, Z) + 0.3))
                       .astype(int))
    sizes = np.minimum(sizes, mean_n * 6)
    xs, ys = [], []
    for z in range(Z):
        cls = rng.choice(n_classes, size=classes_per_dev, replace=False)
        per = np.array_split(np.arange(sizes[z]), classes_per_dev)
        xz = np.zeros((sizes[z], d), np.float32)
        yz = np.zeros((sizes[z],), np.int32)
        for c, idx in zip(cls, per):
            xz[idx] = protos[c] + rng.normal(
                size=(len(idx), d)).astype(np.float32)
            yz[idx] = c
        xs.append(xz)
        ys.append(yz)
    return xs, ys, protos


def shakespeare_like(rng: np.random.Generator, *, Z: int = 109, d: int = 53,
                     k_roles: int = 8, n_per_dev: int = 120):
    """Per-device character-histogram features drawn from k role clusters
    (a structural stand-in for LEAF Shakespeare speaking-role devices)."""
    role_dirichlet = rng.dirichlet(np.ones(d) * 0.3, size=k_roles)
    xs, ys = [], []
    roles = rng.integers(0, k_roles, size=Z)
    for z in range(Z):
        p = role_dirichlet[roles[z]]
        counts = rng.multinomial(400, p, size=n_per_dev).astype(np.float32)
        xs.append(counts / 20.0)
        ys.append(np.full(n_per_dev, roles[z], np.int32))
    return xs, ys, roles
