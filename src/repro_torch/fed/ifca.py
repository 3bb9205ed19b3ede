"""IFCA, the Iterative Federated Clustering Algorithm (Ghosh et al.,
2020); counterpart of ``repro/fed/ifca.py``.

The iterative baseline of Table 2: the server keeps k models; every
round all k are broadcast, each device picks the one with the lowest
local loss, trains it locally, and the server averages per chosen model.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from repro_torch.fed.fedavg import (FedAvgConfig, _leading, cohort_sgd,
                                    weighted_average)
from repro_torch.models.common import tree_map


def ifca_round(loss_fn: Callable, models, device_data, cfg: FedAvgConfig,
               *, point_mask=None):
    """models: params stacked over a leading k axis. Returns (models,
    assignments (Z,) int64, mean_loss). A client picks the first model
    of least loss; a model no client picked keeps its parameters."""
    k = _leading(models).shape[0]
    x = _leading(device_data)
    pm = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
          if point_mask is None else point_mask)
    losses = vmap(lambda data: vmap(lambda m: loss_fn(m, data))(models))(
        device_data)                                         # (Z, k)
    choice = torch.argmin(losses, dim=1)   # the first minimum, as jnp's
    chosen = tree_map(lambda leaf: leaf[choice], models)
    upd = cohort_sgd(loss_fn, chosen, device_data, cfg, pm,
                     batched_params=True)
    updated = []
    for j in range(k):
        w = upd.n * (choice == j)
        has = torch.sum(w) > 0
        avg = weighted_average(upd.params, w)
        updated.append(tree_map(
            lambda a, leaf: torch.where(has, a, leaf[j]), avg, models))
    models = tree_map(lambda *xs: torch.stack(xs), *updated)
    mean_loss = torch.sum(upd.loss * upd.n) / torch.clamp(
        torch.sum(upd.n), min=1e-9)
    return models, choice, mean_loss
