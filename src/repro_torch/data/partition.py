"""Non-IID device partitioners for arbitrary labeled datasets (the
Section 4.2 experiments: structured k'-cluster partitions vs IID random
partitions, with optional power-law device sizes as in Appendix B.1).
Counterpart of ``repro/data/partition.py``: numpy, the same draws from
the same ``np.random.Generator``."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DevicePartition(NamedTuple):
    data: np.ndarray        # (Z, n_max, d) zero-padded
    labels: np.ndarray      # (Z, n_max) target labels, -1 padded
    point_mask: np.ndarray  # (Z, n_max) bool
    k_valid: np.ndarray     # (Z,) clusters present per device
    presence: np.ndarray    # (Z, k) bool


def _pack(chunks_x, chunks_y, k) -> DevicePartition:
    Z = len(chunks_x)
    n_max = max(len(c) for c in chunks_x)
    d = chunks_x[0].shape[1]
    data = np.zeros((Z, n_max, d), np.float32)
    labels = np.full((Z, n_max), -1, np.int32)
    mask = np.zeros((Z, n_max), bool)
    for z, (cx, cy) in enumerate(zip(chunks_x, chunks_y)):
        m = len(cx)
        data[z, :m] = cx
        labels[z, :m] = cy
        mask[z, :m] = True
    presence = np.zeros((Z, k), bool)
    for z in range(Z):
        present = np.unique(labels[z][labels[z] >= 0])
        presence[z, present] = True
    k_valid = presence.sum(1).astype(np.int32)
    return DevicePartition(data, labels, mask, k_valid, presence)


def partition_structured(rng: np.random.Generator, X, y, *, k: int, Z: int,
                         k_prime: int, power_law: float = 0.0
                         ) -> DevicePartition:
    """Each device receives data from <= k_prime random clusters
    (Definition 3.2 heterogeneity). Cluster shards are split evenly among
    the devices that own the cluster; power_law > 0 skews device sizes."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    dev_clusters = [rng.choice(k, size=min(k_prime, k), replace=False)
                    for _ in range(Z)]
    # Ensure every cluster is owned by someone: give orphan clusters a slot
    # on a device, swapping out only clusters that keep >= 2 owners so the
    # swap cannot orphan anything else (requires Z * k_prime >= k).
    def _counts():
        c = np.zeros(k, int)
        for dc in dev_clusters:
            c[dc] += 1
        return c
    counts = _counts()
    for r in np.flatnonzero(counts == 0):
        placed = False
        order = rng.permutation(Z)
        for z in order:
            for i, r_old in enumerate(dev_clusters[z]):
                if counts[r_old] >= 2:
                    counts[r_old] -= 1
                    dev_clusters[z][i] = r
                    counts[r] += 1
                    placed = True
                    break
            if placed:
                break
        if not placed:  # pathological (Z*k' < k): force-assign anyway
            z = int(rng.integers(Z))
            counts[dev_clusters[z][0]] -= 1
            dev_clusters[z][0] = r
            counts[r] += 1
    owners = {r: [z for z in range(Z) if r in dev_clusters[z]]
              for r in range(k)}
    chunks_x = [[] for _ in range(Z)]
    chunks_y = [[] for _ in range(Z)]
    for r in range(k):
        idx = np.flatnonzero(y == r)
        rng.shuffle(idx)
        zs = owners[r]
        w = np.ones(len(zs))
        if power_law > 0:
            w = rng.pareto(power_law, size=len(zs)) + 0.2
        w = w / w.sum()
        splits = np.cumsum((w * len(idx)).astype(int))[:-1]
        for z, part in zip(zs, np.split(idx, splits)):
            chunks_x[z].append(X[part])
            chunks_y[z].append(y[part])
    cx = [np.concatenate(c) if c else np.zeros((0, X.shape[1]), np.float32)
          for c in chunks_x]
    cy = [np.concatenate(c) if c else np.zeros((0,), y.dtype)
          for c in chunks_y]
    return _pack(cx, cy, k)


def partition_iid(rng: np.random.Generator, X, y, *, k: int, Z: int
                  ) -> DevicePartition:
    """Random (IID) partition — the paper's comparison case where k' ~= k."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    idx = rng.permutation(len(X))
    parts = np.array_split(idx, Z)
    return _pack([X[p] for p in parts], [y[p] for p in parts], k)
