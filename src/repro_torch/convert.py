"""State carried across from the JAX package.

The JAX package's serving state is its finished round (the tau centers
and every device's report), its tau centers, or its incremental server
state. Given as numpy arrays (``np.asarray`` of each JAX leaf), these
functions build the port's counterparts on a device, so that
``Session.from_round(plan, convert.round_result(np_round))`` serves from
a round the JAX package computed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import server
from repro_torch.fed import engine as E

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
