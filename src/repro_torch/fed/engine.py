"""The single-host federated engine of one k-FED round (counterpart of
``repro/fed/engine.py``).

One round is four stages: the local solve (Algorithm 1 on every
device), the transport of one report per device (Theta^(z), mask,
optional core-set weights), the server (Algorithm 2, one-shot or as an
incremental fold) and the induced labels (Definition 3.3). Partial
participation is a (Z,) bool mask: absent devices are left out of the
aggregate and attached afterwards by the Theorem 3.2 rule.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from repro_torch.core import server
from repro_torch.core.local_kmeans import LocalKMeansResult, local_kmeans
from repro_torch.utils.prng import GumbelSource


@dataclass(frozen=True)
class EngineConfig:
    """Static configuration of one federated clustering round."""
    k: int                                  # global cluster count
    k_prime: int                            # per-device k^(z) cap
    weight_by_core_counts: bool = False     # weighted server Lloyd round
    local_kw: dict = field(default_factory=dict)  # Algorithm 1 options


class RoundResult(NamedTuple):
    agg: server.KFedAggregate
    device_centers: torch.Tensor   # (Z, k', d)
    center_mask: torch.Tensor      # (Z, k')
    local_assign: torch.Tensor     # (Z, n)
    core_counts: torch.Tensor      # (Z, k') |S_r| from Algorithm 1
    center_labels: torch.Tensor    # (Z, k') incl. post-hoc attached devices
    labels: torch.Tensor           # (Z, n) induced clustering, -1 padded
    participated: torch.Tensor     # (Z,) bool


def core_weights(loc: LocalKMeansResult) -> torch.Tensor:
    """Per-center weights for the server Lloyd round."""
    return server.core_weights(loc.core_counts)


def local_stage(source: GumbelSource, device_data: torch.Tensor,
                cfg: EngineConfig, *, k_valid=None,
                point_mask=None) -> LocalKMeansResult:
    """Stage 1: Algorithm 1 over the device axis. Device z's k-means++
    draws come from ``source`` under id z."""
    Z, n, _ = device_data.shape
    gumbel = source.draw(range(Z), cfg.k_prime, n, device_data.device)
    return local_kmeans(gumbel, device_data, k_max=cfg.k_prime,
                        k_valid=k_valid, point_mask=point_mask,
                        **cfg.local_kw)


def server_stage(loc: LocalKMeansResult, cfg: EngineConfig, *,
                 participation: Optional[torch.Tensor] = None):
    """Stages 2-3: transport masking and the server aggregate, then the
    Theorem 3.2 attachment of absent devices. Returns (agg,
    center_labels (Z, k'), participated (Z,) bool)."""
    Z = loc.centers.shape[0]
    w = core_weights(loc) if cfg.weight_by_core_counts else None
    if participation is None:
        agg = server.aggregate(loc.centers, loc.center_mask, cfg.k,
                               weights=w)
        return agg, agg.center_labels, torch.ones(
            (Z,), dtype=torch.bool, device=loc.centers.device)
    part = torch.as_tensor(participation, dtype=torch.bool,
                           device=loc.centers.device)
    mask = loc.center_mask & part[:, None]
    agg = server.aggregate(loc.centers, mask, cfg.k, weights=w)
    center_labels = server.attach_absent_devices(
        agg.center_labels, loc.centers, loc.center_mask, agg.tau_centers,
        part)
    return agg, center_labels, part


def _finish(loc: LocalKMeansResult, agg, center_labels, part) -> RoundResult:
    labels = server.induced_labels(center_labels, loc.assign)
    return RoundResult(agg, loc.centers, loc.center_mask, loc.assign,
                       loc.core_counts, center_labels, labels, part)


def run_round_impl(source: GumbelSource, device_data: torch.Tensor,
                   cfg: EngineConfig, *,
                   participation: Optional[torch.Tensor] = None,
                   k_valid=None, point_mask=None) -> RoundResult:
    """One synchronous k-FED round, optionally with partial
    participation. The declarative surface is ``fed.api.Session.run``."""
    loc = local_stage(source, device_data, cfg, k_valid=k_valid,
                      point_mask=point_mask)
    agg, center_labels, part = server_stage(loc, cfg,
                                            participation=participation)
    return _finish(loc, agg, center_labels, part)
