"""State carried across from the JAX package.

The JAX package's serving state is its finished round (the tau centers
and every device's report), its tau centers, or its incremental server
state. Given as numpy arrays (``np.asarray`` of each JAX leaf), these
functions build the port's counterparts on a device, so that
``Session.from_round(plan, convert.round_result(np_round))`` serves from
a round the JAX package computed, and ``heads=convert.heads(np_heads)``
with the JAX package's per-cluster head parameters,
``encoder=convert.encoder(np_encoder)`` with its ingestion encoder's; and
``model_params`` carries a JAX ``Model.init`` pytree across for the
port's ``models.model.Model``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import server
from repro_torch.fed import engine as E
from repro_torch.models.common import tree_map

_INT = torch.int32


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.array(x), device=device, dtype=dtype)


def tau(tau_centers, device="cuda") -> torch.Tensor:
    """Retained tau centers (k, d) as f32."""
    return _t(tau_centers, device, torch.float32)


def aggregate(agg, device="cuda") -> server.KFedAggregate:
    """A ``KFedAggregate`` (seeds_idx, seed_centers, tau_centers,
    center_labels, z0)."""
    return server.KFedAggregate(
        _t(agg.seeds_idx, device, _INT),
        _t(agg.seed_centers, device, torch.float32),
        _t(agg.tau_centers, device, torch.float32),
        _t(agg.center_labels, device, _INT), _t(agg.z0, device, _INT))


def round_result(rr, device="cuda") -> E.RoundResult:
    """A finished round: ``agg.*``, ``device_centers``, ``center_mask``,
    ``local_assign``, ``core_counts``, ``center_labels``, ``labels`` and
    ``participated``."""
    return E.RoundResult(
        aggregate(rr.agg, device),
        _t(rr.device_centers, device, torch.float32),
        _t(rr.center_mask, device, torch.bool),
        _t(rr.local_assign, device, _INT),
        _t(rr.core_counts, device, torch.float32),
        _t(rr.center_labels, device, _INT),
        _t(rr.labels, device, _INT),
        _t(rr.participated, device, torch.bool))


def server_state(state, device="cuda") -> server.ServerState:
    """An incremental fold state (centers, mask, weights, received,
    epoch)."""
    return server.ServerState(
        _t(state.centers, device, torch.float32),
        _t(state.mask, device, torch.bool),
        _t(state.weights, device, torch.float32),
        _t(state.received, device, torch.bool),
        _t(state.epoch, device, _INT))


def _f32_tree(np_tree, device):
    return tree_map(lambda a: _t(np.asarray(a, np.float32), device,
                                 torch.float32), np_tree)


def heads(np_tree, device="cuda"):
    """Per-cluster head parameters: the JAX package's ``init_heads``
    pytree (nested dicts of ``(k, ...)`` arrays) as the port's nested
    dicts of f32 tensors. The head casts to its storage dtype itself."""
    return _f32_tree(np_tree, device)


def encoder(np_tree, device="cuda"):
    """Ingestion-encoder parameters: the JAX package's ``init_encoder``
    pytree (``layers`` of ``(n_layers, ...)`` arrays and ``norm_f``) as
    the port's nested dicts of f32 tensors, the same layout. The encoder
    casts to its storage dtype itself."""
    return _f32_tree(np_tree, device)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 (numpy's
    extension type from ``np.asarray`` of a JAX bf16 array) by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _t(a.view(np.int16), device).view(torch.bfloat16)
    return _t(a, device)


def model_params(np_tree, device="cuda"):
    """A JAX ``Model.init`` pytree (dicts, with ``segments`` a tuple of
    dicts of layer-stacked arrays; leaves as numpy) as the port's
    parameters: the same nesting, every leaf a tensor of its own dtype
    on ``device``."""
    return tree_map(lambda a: _tensor(a, device), np_tree)
