"""Client-side computation (counterpart of ``repro/fed/client.py``):
local SGD on a device's data, and the summary vectors k-FED clusters
(mean embeddings, update sketches).

Parameters are nested dicts of tensors. ``local_sgd`` runs one client;
``torch.func.vmap`` over it runs a cohort, each client with its own
exact gradient (``fed/fedavg.py``, ``fed/ifca.py``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import grad_and_value

from repro_torch.models.common import tree_map


class ClientUpdate(NamedTuple):
    params: dict          # updated local params
    n: torch.Tensor       # local example count (weight for averaging)
    loss: torch.Tensor    # the loss before the last step


def local_sgd(loss_fn: Callable, params, data, *, lr: float,
              epochs: int, point_mask=None) -> ClientUpdate:
    """``epochs`` full-batch gradient steps of ``loss_fn(params, data)``.
    ``point_mask`` only sets the client's weight ``n``: the loss sees
    what ``data`` holds (its ``"mask"``), as in the reference."""
    n = (torch.sum(point_mask.float()) if point_mask is not None
         else torch.tensor(float(data["x"].shape[0])))
    step = grad_and_value(loss_fn)
    loss = None
    for _ in range(epochs):
        g, loss = step(params, data)
        params = tree_map(lambda w, gw: w - lr * gw, params, g)
    return ClientUpdate(params, n, loss)


def summary_vector(embed_fn: Callable, params, data, point_mask=None):
    """Mean embedding of a client's data: the vector Algorithm 1 runs on
    when k-FED clusters clients rather than raw points."""
    e = embed_fn(params, data)                       # (n, d)
    if point_mask is None:
        return torch.mean(e, dim=0)
    w = point_mask.to(e.dtype)[:, None]
    return torch.sum(e * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)


def _leaves(tree):
    """Leaves of nested dicts in the reference's order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def delta_sketch(old_params, new_params, dim: int = 256) -> torch.Tensor:
    """A deterministic low-dimensional sketch of a model delta (strided
    bucket sums of the flattened difference): another clustering
    feature for k-FED."""
    v = torch.cat([(a - b).float().reshape(-1) for a, b in
                   zip(_leaves(new_params), _leaves(old_params))])
    n = v.shape[0]
    vb = torch.nn.functional.pad(v, (0, (-n) % dim)).reshape(-1, dim)
    return torch.sum(vb, dim=0) / math.sqrt(max(n, 1))
