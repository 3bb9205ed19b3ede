"""Per-cluster personalization (counterpart of
``repro/fed/personalize.py``; Section 4.2.2 and Table 2 of the paper).

``majority_vote`` assigns a request (or device) one cluster from its
per-point labels; the routed serving step routes by it. k-FED +
FedAvg personalization: one-shot clustering of client summary vectors
(``Session.run``, the one-shot round) gives every device a cluster, and
one model per cluster is then trained with FedAvg over that cluster's
members. After the clustering the server ships one model per device per
round, against IFCA's k.

The clustering runs where the features lie: tensors on the card run it
there, and the caller asks for the CPU by passing CPU tensors (or
``device="cpu"``). ``key`` is an int seed or a
``utils.prng.GumbelSource`` keying the k-means++ draws.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.fed.fedavg import FedAvgConfig, _leading, fedavg_round
from repro_torch.models.common import tree_map


def majority_vote(labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row majority cluster. labels: (Z, n) int with -1 for masked
    points; returns (Z,) int32. Counts are a fixed-order one-hot sum
    (no bincount), and ties go to the smallest cluster id, as in the
    reference; a row with no valid point votes 0."""
    cols = torch.arange(k, device=labels.device, dtype=labels.dtype)
    counts = torch.sum((labels.unsqueeze(-1) == cols).float(), dim=1)
    # torch.argmax returns the first maximal index, like jnp.argmax.
    return torch.argmax(counts, dim=1).to(torch.int32)


def cluster_devices(key, features, k: int, k_prime: int = 1, *,
                    device=None):
    """Cluster devices by their summary vectors. features: (Z, n_feat,
    d): with n_feat == 1 this is device-level clustering (k' = 1, the
    Table 2 setup); with more, every device's feature set is clustered
    and the device takes its majority cluster. Returns (device cluster
    (Z,) int32, the round's ``engine.RoundResult``)."""
    from repro_torch.fed.api import FederationPlan, Session
    if device is None:
        device = (features.device if isinstance(features, torch.Tensor)
                  else "cuda")
    plan = FederationPlan(k=k, k_prime=k_prime, d=int(features.shape[-1]),
                          device=str(device))
    res = Session(plan).run(key, features).detail
    return majority_vote(res.labels, k), res


def kfed_personalize(key, loss_fn: Callable, init_params, device_data,
                     features, k: int, cfg: FedAvgConfig, *,
                     k_prime: int = 1, point_mask=None,
                     per_chunk: bool = False):
    """One-shot clustering, then per-cluster FedAvg.

    ``per_chunk=False``: one cluster a device by majority vote (the
    k' = 1 rows of Table 2). ``per_chunk=True``: k-FED clusters data, so
    a mixed device trains each of its feature chunks with that chunk's
    own cluster model. Chunks are the contiguous ``array_split`` shards
    of the device's points, matching the (Z, n_feat, .) feature layout.
    A member trains on all of its points and is weighted by its count
    in the cluster, as in the reference.

    Returns (models stacked over k, assignment, history): assignment is
    (Z,) per device or (Z, n_feat) per chunk; history[j] the mean loss
    of each of cluster j's rounds.
    """
    x = _leading(device_data)
    dev = x.device
    device_cluster, res = cluster_devices(key, features, k, k_prime,
                                          device=dev)
    Z, n = x.shape[0], x.shape[1]
    n_feat = features.shape[1]
    base_pm = (torch.ones((Z, n), dtype=torch.bool, device=dev)
               if point_mask is None else point_mask)
    if per_chunk and n_feat > 1:
        lbl = res.labels                              # (Z, n_feat)
        sizes = [(n // n_feat) + (1 if c < n % n_feat else 0)
                 for c in range(n_feat)]
        chunk_of = torch.cat([torch.full((s,), c, dtype=torch.long,
                                         device=dev)
                              for c, s in enumerate(sizes)])
        point_lbl = lbl[:, chunk_of]
        assignment = lbl
    else:
        point_lbl = device_cluster[:, None].expand(Z, n)
        assignment = device_cluster

    models, history = [], []
    for j in range(k):
        pm_j = base_pm & (point_lbl == j)
        member = pm_j.any(dim=1).float()
        params = init_params
        losses = []
        for _ in range(cfg.rounds):
            params, loss = fedavg_round(loss_fn, params, device_data, cfg,
                                        point_mask=pm_j, member_mask=member)
            losses.append(loss)
        models.append(params)
        history.append(torch.stack(losses).tolist() if losses else [])
    models = tree_map(lambda *xs: torch.stack(xs), *models)
    return models, assignment, history
