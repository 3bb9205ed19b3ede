"""FedAvg (McMahan et al., 2017), counterpart of ``repro/fed/fedavg.py``:
the aggregation the personalization experiment builds on (k-FED
clusters first, FedAvg trains one model per cluster)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.func import vmap

from repro_torch.fed.client import ClientUpdate, local_sgd
from repro_torch.models.common import tree_map


@dataclass(frozen=True)
class FedAvgConfig:
    lr: float = 0.05
    local_epochs: int = 5
    rounds: int = 20


def make_local_step(loss_fn: Callable, cfg: FedAvgConfig):
    def run(params, data, point_mask=None):
        return local_sgd(loss_fn, params, data, lr=cfg.lr,
                         epochs=cfg.local_epochs, point_mask=point_mask)
    return run


def weighted_average(params_stack, weights: torch.Tensor):
    """params_stack: params with a leading client axis; weights: (Z,).
    Each leaf is averaged in f32 and cast back to its dtype."""
    w = weights.float()
    w = w / torch.clamp(torch.sum(w), min=1e-9)
    return tree_map(lambda leaf: torch.tensordot(
        w, leaf.float(), dims=1).to(leaf.dtype), params_stack)


def _leading(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def cohort_sgd(loss_fn: Callable, params, device_data, cfg: FedAvgConfig,
               point_mask, *, batched_params: bool = False) -> ClientUpdate:
    """``local_sgd`` on every client of ``device_data`` (a dict with a
    leading (Z, ...) client axis) at once, from ``params`` (shared, or
    one set a client with ``batched_params``)."""
    local = make_local_step(loss_fn, cfg)
    return vmap(local, in_dims=(0 if batched_params else None, 0, 0))(
        params, device_data, point_mask)


def fedavg_round(loss_fn: Callable, global_params, device_data,
                 cfg: FedAvgConfig, *, point_mask=None, member_mask=None):
    """One synchronous round over the client cohort.

    device_data: dict with a leading (Z, ...) client axis. member_mask:
    (Z,) 0/1 weights of the clients that take part (the per-cluster
    FedAvg of the personalization pipeline). Returns
    (new_global_params, mean_loss).
    """
    x = _leading(device_data)
    pm = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
          if point_mask is None else point_mask)
    upd = cohort_sgd(loss_fn, global_params, device_data, cfg, pm)
    weights = upd.n
    if member_mask is not None:
        weights = weights * member_mask
    new_params = weighted_average(upd.params, weights)
    mean_loss = torch.sum(upd.loss * weights) / torch.clamp(
        torch.sum(weights), min=1e-9)
    return new_params, mean_loss
