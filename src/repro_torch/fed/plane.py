"""The single-host serve plane (counterpart of ``repro/fed/plane.py``
without its mesh, routed-head and encoder parts).

It owns the two device computations of the serving hot path — the serve
step and the fold scatter — and the double-buffered, versioned tau the
step reads. Queues, buckets, policies and refresh cadence live in
``fed/stream.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import server
from repro_torch.core.lloyd import lloyd_attach
from repro_torch.core.local_kmeans import local_prepare, split_local_kw

__all__ = ["ServePlane", "TauBuffer"]


class TauBuffer(NamedTuple):
    """Double-buffered tau centers with an atomic version counter.

    ``bufs[active]`` is what the serve step reads; ``stage`` fills the
    standby without touching serving, and ``commit`` flips ``active``
    and bumps ``version`` by one, so a request's recorded version names
    exactly the tau that labelled it. ``swap_now`` is stage + commit.
    Every transition returns a new TauBuffer."""
    bufs: torch.Tensor   # (2, k, d) f32
    active: int          # which buffer serves
    version: int         # bumps exactly once per commit
    pending: bool        # standby staged, swap deferred to a boundary

    @classmethod
    def fresh(cls, tau: torch.Tensor) -> "TauBuffer":
        t = tau.float()
        return cls(torch.stack([t, t]), 0, 0, False)

    @property
    def tau(self) -> torch.Tensor:
        return self.bufs[self.active]

    def stage(self, new_tau: torch.Tensor) -> "TauBuffer":
        t = new_tau.float()
        cur = self.bufs[self.active]
        bufs = torch.stack([cur, t] if self.active == 0 else [t, cur])
        return TauBuffer(bufs, self.active, self.version, True)

    def commit(self) -> "TauBuffer":
        return TauBuffer(self.bufs, 1 - self.active, self.version + 1, False)

    def swap_now(self, new_tau: torch.Tensor) -> "TauBuffer":
        return self.stage(new_tau).commit()


def _make_step(cfg):
    """The serve-step body: Algorithm 1 steps 1-3 over the request batch,
    then the fused bounded Lloyd + Theorem 3.2 attach + Definition 3.3
    labels in one ``lloyd_attach`` launch (``cfg.serve_dtype`` f32, or
    bf16 storage with f32 accumulation)."""
    prep_kw, max_iters = split_local_kw(cfg.local_kw)

    def step(tau, gumbel, data, point_mask, k_valid):
        prep = local_prepare(gumbel, data, k_max=cfg.k_prime,
                             k_valid=k_valid, point_mask=point_mask,
                             **prep_kw)
        labels, _, centers, _ = lloyd_attach(
            data, prep.theta, tau, center_mask=prep.center_mask,
            point_mask=point_mask, max_iters=max_iters,
            serve_dtype=cfg.serve_dtype)
        return (labels, centers, prep.center_mask,
                server.core_weights(prep.core_counts))

    return step


class ServePlane:
    """Serve step + fold scatter on one device."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self._step = _make_step(cfg)
        self.steps = 0
        self.folds = 0

    def step(self, tau, gumbel, data, point_mask, k_valid):
        """Serve one fixed-shape (B, n_pad, d) batch. ``gumbel``: the
        batch's k-means++ noise (B, k', n_pad). Returns (labels
        (B, n_pad), centers (B, k', d), center_mask (B, k'), core
        weights (B, k'))."""
        self.steps += 1
        return self._step(tau, gumbel, data, point_mask, k_valid)

    def localize(self, x) -> torch.Tensor:
        """A tensor on the plane's device."""
        return torch.as_tensor(x, device=self.device)

    def fold(self, state, slots, centers, cmask, weights=None, epochs=None):
        """Scatter one batch of admitted reports into the fold state;
        slots at or beyond the capacity are dropped. ``epochs``: the
        request ids stamped on the slots (default: the slots)."""
        self.folds += 1
        if weights is None:
            weights = torch.ones(cmask.shape, dtype=torch.float32,
                                 device=self.device)
        return server.aggregate_incremental(
            state, slots, centers, cmask, weights=weights,
            epochs=slots if epochs is None else epochs)

    def describe(self) -> dict:
        return {"serve_axes": None, "serve_shards": 1,
                "serve_device": str(self.device),
                "plane_steps": self.steps, "plane_folds": self.folds}
