"""Fold-slot admission (counterpart of ``repro/fed/policy.py``; numpy,
host side).

The incremental server buffers one report per slot, and
``core.server.aggregate_incremental`` stays the one fold primitive. A
``FoldPolicy`` maps request ids to slots. This slice has the ``drop``
rule: the slot is the request id, and ids past ``capacity`` are served
but never folded. The ``lru`` and ``weighted_reservoir`` policies of the
JAX package are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["FoldPolicy", "DropPolicy", "POLICIES", "make_policy"]


class FoldPolicy:
    """Maps request ids to fold slots; owns eviction. ``admit(rid,
    weight)`` returns the slot for the report, or None to serve it
    without folding. A policy is a deterministic function of its state,
    the id and the weight."""

    name: str = "abstract"

    def __init__(self, capacity: int):
        self.capacity = int(capacity)

    def admit(self, rid: int, weight: float = 1.0) -> Optional[int]:
        raise NotImplementedError

    def admit_batch(self, rids, weights=None):
        """Admission for one serve batch, in request order. Returns
        ``(slots, granted)``: an int64 slot vector with -1 for declined
        requests, and the number of admissions granted (what the refresh
        cadence counts). Where a later admission in the batch takes a
        slot an earlier one was granted, only the later keeps it, so the
        whole vector folds as one overwrite."""
        owner: Dict[int, int] = {}      # slot -> batch index holding it
        granted = 0
        for i, rid in enumerate(rids):
            w = 1.0 if weights is None else float(weights[i])
            slot = self.admit(int(rid), w)
            if slot is None:
                continue
            granted += 1
            owner[slot] = i
        slots = np.full((len(rids),), -1, np.int64)
        for slot, i in owner.items():
            slots[i] = slot
        return slots, granted

    def admit_padded(self, rids, weights=None, *, total=None):
        """:meth:`admit_batch` padded to the serve batch: returns
        ``((total,) int64 slots, granted)`` where declined requests and
        the batch's repeat-padding rows carry the out-of-capacity slot
        the fold drops."""
        slots, granted = self.admit_batch(rids, weights)
        full = np.full((total or len(rids),), self.capacity, np.int64)
        full[:len(slots)] = np.where(slots < 0, self.capacity, slots)
        return full, granted


class DropPolicy(FoldPolicy):
    """Slot == request id; over-capacity ids are dropped."""

    name = "drop"

    def admit(self, rid: int, weight: float = 1.0) -> Optional[int]:
        return rid if rid < self.capacity else None


POLICIES = {"drop": DropPolicy}


def make_policy(name: str, capacity: int) -> FoldPolicy:
    if name not in POLICIES:
        raise ValueError(f"fold_policy={name!r} is not in the PyTorch "
                         f"port yet (it has {sorted(POLICIES)})")
    return POLICIES[name](capacity)
