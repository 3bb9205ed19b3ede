"""Fold-slot admission (counterpart of ``repro/fed/policy.py``; numpy,
host side).

The incremental server buffers one report per slot, and
``core.server.aggregate_incremental`` stays the one fold primitive. A
``FoldPolicy`` maps request ids to slots:

  * ``drop``: the slot is the request id; ids past ``capacity`` are
    served but never folded;
  * ``lru``: a full state evicts the least recently folded occupant's
    slot, and re-delivery of a held id touches its recency, so the
    state holds the ``capacity`` most recently reporting devices;
  * ``weighted_reservoir``: Efraimidis-Spirakis A-ES sampling. Each id
    draws the key u(seed, id)^(1/weight) and the state keeps the
    ``capacity`` largest (key, id) pairs seen, so heavy devices (large
    Algorithm 1 core sets) are the likelier to stay folded.

Eviction is an overwrite of the victim's slot. Every decision is a
function of the policy's state, the id and the weight, never of arrival
time, and the state checkpoints under the JAX package's keys, so a
restored service in either package replays the admissions exactly.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["FoldPolicy", "DropPolicy", "LruPolicy",
           "WeightedReservoirPolicy", "POLICIES", "POLICY_IDS",
           "make_policy"]


class FoldPolicy:
    """Maps request ids to fold slots; owns eviction. ``admit(rid,
    weight)`` returns the slot for the report, or None to serve it
    without folding. A policy is a deterministic function of its state,
    the id and the weight."""

    name: str = "abstract"
    needs_weight: bool = False  # admit() wants the report's |S_r| mass

    def __init__(self, capacity: int):
        self.capacity = int(capacity)

    def admit(self, rid: int, weight: float = 1.0) -> Optional[int]:
        raise NotImplementedError

    # -- checkpoint plumbing (the ``policy`` subtree of an archive) -----
    def state_like(self) -> Dict[str, np.ndarray]:
        """Zero-filled arrays matching :meth:`state_arrays` (the restore
        template for ``checkpoint.store.load_pytree``)."""
        return {}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {}

    def load_state(self, arrays: Dict[str, np.ndarray]) -> None:
        pass

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


class LruPolicy(FoldPolicy):
    """Least recently folded eviction over ``capacity`` slots. The held
    ids are always the ``capacity`` most recently admitted distinct ids,
    and every admission is granted."""

    name = "lru"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._slot_rid = np.full((self.capacity,), -1, np.int64)
        self._slot_seq = np.full((self.capacity,), -1, np.int64)
        self._seq = 0
        self._index: Dict[int, int] = {}

    def admit(self, rid: int, weight: float = 1.0) -> Optional[int]:
        slot = self._index.get(rid)
        if slot is None:
            free = np.nonzero(self._slot_rid < 0)[0]
            if free.size:
                slot = int(free[0])
            else:  # evict the least recently folded occupant
                slot = int(np.argmin(self._slot_seq))
                del self._index[int(self._slot_rid[slot])]
            self._slot_rid[slot] = rid
            self._index[rid] = slot
        self._slot_seq[slot] = self._seq
        self._seq += 1
        return slot

    def state_like(self) -> Dict[str, np.ndarray]:
        return {"slot_rid": np.zeros((self.capacity,), np.int64),
                "slot_seq": np.zeros((self.capacity,), np.int64),
                "seq": np.zeros((), np.int64)}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {"slot_rid": self._slot_rid.copy(),
                "slot_seq": self._slot_seq.copy(),
                "seq": np.asarray(self._seq, np.int64)}

    def load_state(self, arrays: Dict[str, np.ndarray]) -> None:
        self._slot_rid = np.asarray(arrays["slot_rid"], np.int64).copy()
        self._slot_seq = np.asarray(arrays["slot_seq"], np.int64).copy()
        self._seq = int(arrays["seq"])
        self._index = {int(r): i for i, r in enumerate(self._slot_rid)
                       if r >= 0}


class WeightedReservoirPolicy(FoldPolicy):
    """A-ES weighted reservoir over the fold slots.

    Each distinct id draws key = u^(1/max(weight, eps)), u uniform in
    (0, 1) from ``np.random.default_rng((seed, id))``; the state holds
    the ``capacity`` largest (key, id) pairs seen, whatever the arrival
    order, and a held id keeps its slot on re-delivery. With
    ``half_life`` > 0 the weight decays as w * 2^(-rid / half_life), the
    key taken in the log domain as log(u) * 2^(-rid / h) / w (the same
    order, without underflow at large ids); ``half_life=0`` gives the
    undecayed key."""

    name = "weighted_reservoir"
    needs_weight = True
    _EPS = 1e-9

    def __init__(self, capacity: int, seed: int = 0, half_life: int = 0):
        super().__init__(capacity)
        self.seed = int(seed)
        self.half_life = int(half_life)
        self._slot_rid = np.full((self.capacity,), -1, np.int64)
        self._slot_key = np.full((self.capacity,), -np.inf, np.float64)
        self._index: Dict[int, int] = {}

    def key_of(self, rid: int, weight: float) -> float:
        u = np.random.default_rng((self.seed, int(rid))).random()
        if self.half_life > 0:
            return float(np.log(u) * np.exp2(-float(rid) / self.half_life)
                         / max(float(weight), self._EPS))
        return float(u ** (1.0 / max(float(weight), self._EPS)))

    def admit(self, rid: int, weight: float = 1.0) -> Optional[int]:
        slot = self._index.get(rid)
        if slot is not None:
            return slot  # re-delivery: key and slot unchanged
        key = self.key_of(rid, weight)
        free = np.nonzero(self._slot_rid < 0)[0]
        if free.size:
            slot = int(free[0])
        else:
            victim = int(np.lexsort((self._slot_rid, self._slot_key))[0])
            if (key, rid) <= (float(self._slot_key[victim]),
                              int(self._slot_rid[victim])):
                return None  # below the reservoir's threshold
            del self._index[int(self._slot_rid[victim])]
            slot = victim
        self._slot_rid[slot] = rid
        self._slot_key[slot] = key
        self._index[rid] = slot
        return slot

    def state_like(self) -> Dict[str, np.ndarray]:
        return {"slot_rid": np.zeros((self.capacity,), np.int64),
                "slot_key": np.zeros((self.capacity,), np.float64)}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return {"slot_rid": self._slot_rid.copy(),
                "slot_key": self._slot_key.copy()}

    def load_state(self, arrays: Dict[str, np.ndarray]) -> None:
        self._slot_rid = np.asarray(arrays["slot_rid"], np.int64).copy()
        self._slot_key = np.asarray(arrays["slot_key"], np.float64).copy()
        self._index = {int(r): i for i, r in enumerate(self._slot_rid)
                       if r >= 0}


POLICIES = {"drop": DropPolicy, "lru": LruPolicy,
            "weighted_reservoir": WeightedReservoirPolicy}

# The JAX package's numeric codes of the fold policies, as a checkpoint
# stores them (npz holds no strings): an archive restores only under the
# policy that wrote it.
POLICY_IDS = {"drop": 0, "lru": 1, "weighted_reservoir": 2}


def make_policy(name: str, capacity: int, *, seed: int = 0,
                half_life: int = 0) -> FoldPolicy:
    if name not in POLICIES:
        raise ValueError(f"fold_policy={name!r}: accepted values are "
                         f"{sorted(POLICIES)}")
    if name == "weighted_reservoir":
        return WeightedReservoirPolicy(capacity, seed=seed,
                                       half_life=half_life)
    return POLICIES[name](capacity)
