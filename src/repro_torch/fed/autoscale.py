"""Load-adaptive serve-plane scaling (counterpart of
``repro/fed/autoscale.py``; numpy, host side; DESIGN.md §12).

At flush boundaries only, a deterministic controller re-selects

  * the **active shard count**, within the devices the plan granted
    (one on a single card);
  * the **serve batch size**, a power-of-two rung within the plan's
    ``batch_size`` ceiling (a flush of 3 queued requests pads to 4, not
    to 8: repeat-padding rows are real compute);
  * the **active bucket ladder**: under oversized load the queued
    above-ladder requests are re-bucketed into one coalesced pad rung
    instead of spreading over the doubling ladder.

A decision is a pure function of a :class:`QueueSnapshot` (the queue's
depth and its histogram over the base ladder, both functions of the
request stream alone) and of the controller's own state (the previous
decision and the shrink streak), which the schema-v3 checkpoint stores.
Wall-clock telemetry (:class:`FlushTelemetry`) is recorded for
``stats()`` and is never a decision input, so a restored service replays
the decision sequence, and with it the fold and refresh boundaries,
exactly. Each (batch, rung) pair is one step shape; the serve plane
counts the distinct ones (``plane_compiles``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["AUTOSCALE_POLICIES", "AUTOSCALE_IDS", "AutoscaleError",
           "AutoscaleController", "AutoscaleDecision", "FlushTelemetry",
           "QueueSnapshot", "bucket_of", "decide", "pow2_ceil",
           "shards_for", "snapshot_queue"]

AUTOSCALE_POLICIES = ("off", "latency", "throughput")

# The JAX package's numeric codes of the policies, as a checkpoint
# stores them (npz holds no strings): an archive restores only under the
# policy that wrote its decision state.
AUTOSCALE_IDS = {"off": 0, "latency": 1, "throughput": 2}

# Shrink only after this many consecutive shallow flushes (throughput
# policy): one thin flush inside a burst must not collapse the batch.
SHRINK_STREAK = 2


class AutoscaleError(ValueError):
    """An autoscale configuration failed validation (named, with the
    accepted values), raised at construction."""


def bucket_of(n: int, ladder: Tuple[int, ...]) -> int:
    """The pad rung of an n-point request, shared by the service's
    bucketing and the controller's histogram: the smallest ladder rung
    holding n points, doubling above the top rung."""
    for b in ladder:
        if n <= b:
            return int(b)
    b = int(ladder[-1])
    while b < n:
        b *= 2
    return b


class QueueSnapshot(NamedTuple):
    """What a decision may read at a flush boundary: the queue depth and
    its histogram over the base ladder's rungs. ``mass`` is the drift
    layer's per-center fold mass (empty with drift off); no policy reads
    it yet."""
    pending: int                              # queue depth at the boundary
    hist: Tuple[Tuple[int, int], ...]         # ascending (rung, count)
    mass: Tuple[float, ...] = ()


class FlushTelemetry(NamedTuple):
    """Wall-clock observability of one flush's two phases: recorded,
    shown in ``stats()``, never a decision input."""
    dispatch_us: int        # phase 1: every batch's step and fold launched
    materialize_us: int     # phase 2: labels brought to the host
    batches: int
    requests: int
    points: int


class AutoscaleDecision(NamedTuple):
    """One flush's selection. ``seq`` counts decisions (one a non-empty
    flush), so a replay can be held to the uninterrupted run decision
    by decision."""
    shards: int                   # active serve shards (<= granted)
    batch_size: int               # active step batch (<= plan ceiling)
    ladder: Tuple[int, ...]       # active pad-bucket ladder
    seq: int


def snapshot_queue(pending_ns, base_ladder, mass=()) -> QueueSnapshot:
    """Histogram of the queued point counts over the base ladder's rungs
    (doubling rungs above the top): the controller's one view of the
    queue."""
    hist: Dict[int, int] = {}
    for n in pending_ns:
        b = bucket_of(int(n), tuple(base_ladder))
        hist[b] = hist.get(b, 0) + 1
    return QueueSnapshot(pending=len(pending_ns),
                         hist=tuple(sorted(hist.items())),
                         mass=tuple(float(m) for m in mass))


def pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _pow2_floor(x: int) -> int:
    return 1 << (int(x).bit_length() - 1)


def shards_for(batch: int, granted: int, n_axes: int) -> int:
    """The most parallel active shard count the batch divides over: the
    whole grant when it fits; otherwise (single-axis grants only) the
    largest power of two dividing both."""
    if batch % granted == 0:
        return granted
    if n_axes > 1:
        return 1
    return min(_pow2_floor(granted), batch)


def _ladder_for(policy: str, snap: QueueSnapshot, batch: int,
                base_ladder: Tuple[int, ...]) -> Tuple[int, ...]:
    """The active ladder: the base rungs plus the queued oversized
    rungs, coalesced into the largest occupied one when the flush is
    load-heavy (throughput always; latency once the oversized backlog
    alone fills a batch)."""
    top = base_ladder[-1]
    over = [(r, c) for r, c in snap.hist if r > top]
    if not over:
        return base_ladder
    if len(over) > 1 and (policy == "throughput"
                          or sum(c for _, c in over) >= batch):
        return base_ladder + (over[-1][0],)
    return base_ladder + tuple(r for r, _ in over)


def decide(policy: str, snap: QueueSnapshot, *, max_batch: int,
           granted: int, n_axes: int, base_ladder: Tuple[int, ...],
           prev: AutoscaleDecision,
           streak: int) -> Tuple[AutoscaleDecision, int]:
    """The decision rule, for the adaptive policies (``off`` never
    reaches it):

    * ``latency``: the batch tracks the queue depth both ways (the next
      power of two, capped at the plan's ceiling);
    * ``throughput``: grows as ``latency`` does but shrinks only after
      :data:`SHRINK_STREAK` consecutive shallow flushes.

    The shard count follows the batch (``shards_for``) and the ladder
    re-buckets oversized backlog (``_ladder_for``)."""
    target = min(pow2_ceil(max(snap.pending, 1)), int(max_batch))
    if policy == "latency":
        batch, streak = target, 0
    elif target >= prev.batch_size:
        batch, streak = target, 0
    else:
        streak += 1
        if streak >= SHRINK_STREAK:
            batch, streak = target, 0
        else:
            batch = prev.batch_size
    return (AutoscaleDecision(
        shards=shards_for(batch, granted, n_axes),
        batch_size=batch,
        ladder=_ladder_for(policy, snap, batch, tuple(base_ladder)),
        seq=prev.seq + 1), streak)


class AutoscaleController:
    """The decision state of one ``AttachService``: observe a queue
    snapshot at each flush boundary, give the flush its decision, and
    checkpoint the state that replays the decision sequence (schema
    v3)."""

    def __init__(self, policy: str, *, max_batch: int, granted: int,
                 n_axes: int, base_ladder: Tuple[int, ...]):
        if policy not in AUTOSCALE_POLICIES:
            raise AutoscaleError(
                f"autoscale={policy!r} is invalid: accepted values are "
                f"{list(AUTOSCALE_POLICIES)}")
        self.policy = policy
        self.max_batch = int(max_batch)
        self.granted = int(granted)
        self.n_axes = int(n_axes)
        self.base_ladder = tuple(int(b) for b in base_ladder)
        # Before any traffic the decision is the plan's static one, and
        # "off" never leaves it.
        self.decision = AutoscaleDecision(self.granted, self.max_batch,
                                          self.base_ladder, 0)
        self.streak = 0
        self.telemetry: Optional[FlushTelemetry] = None

    def observe(self, snap: QueueSnapshot) -> AutoscaleDecision:
        """One flush boundary: fold the snapshot into the state and
        return the decision the flush runs under."""
        if self.policy == "off":
            return self.decision
        self.decision, self.streak = decide(
            self.policy, snap, max_batch=self.max_batch,
            granted=self.granted, n_axes=self.n_axes,
            base_ladder=self.base_ladder, prev=self.decision,
            streak=self.streak)
        return self.decision

    def record(self, telemetry: FlushTelemetry) -> None:
        """Keep the flush's wall-clock telemetry (observability only)."""
        self.telemetry = telemetry

    # -- checkpoint plumbing (the v3 schema arrays) ---------------------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        d = self.decision
        return {
            "autoscale_state": np.asarray(
                [d.shards, d.batch_size, d.seq, self.streak], np.int64),
            "autoscale_ladder": np.asarray(d.ladder, np.int64),
        }

    def load_state(self, state, ladder) -> None:
        """Adopt an archive's decision state, reconciled with this
        controller's configuration: the batch rung clamps to the current
        ceiling and the shard count follows the current grant (the
        identity under an unchanged configuration). ``off`` keeps the
        plan's static decision and takes only the decision count."""
        s = np.asarray(state, np.int64)
        seq = int(s[2])
        if self.policy == "off":
            self.decision = self.decision._replace(seq=seq)
            self.streak = 0
            return
        batch = min(int(s[1]), self.max_batch)
        self.decision = AutoscaleDecision(
            shards_for(batch, self.granted, self.n_axes), batch,
            tuple(int(b) for b in np.asarray(ladder, np.int64)), seq)
        self.streak = int(s[3])

    def stats(self) -> dict:
        d, t = self.decision, self.telemetry
        return {
            "policy": self.policy,
            "shards": d.shards,
            "batch_size": d.batch_size,
            "ladder": list(d.ladder),
            "decisions": d.seq,
            "granted_shards": self.granted,
            "max_batch": self.max_batch,
            "last_dispatch_us": t.dispatch_us if t else None,
            "last_materialize_us": t.materialize_us if t else None,
            "last_batches": t.batches if t else None,
        }
