"""The streaming attachment service, single-host path (counterpart of
``repro/fed/stream.py``).

After the one round, Theorem 3.2 attaches any late device in O(k'k)
with no extra round. This service batches such requests: they are
bucketed by padded point count, padded into fixed ``(batch_size, n_pad,
d)`` shapes with point masks and served by the plane's step. Each served
report can be folded into the incremental server state, and every
``refresh_every`` folds the round is finalized again so tau tracks the
population. tau is double-buffered and versioned, and every served
label carries the version that produced it. A request's k-means++ draws
depend on its own request id only, so batching never changes labels.

Not in the port yet: autoscaling, the async refresh, the ``lru`` and
``weighted_reservoir`` admission policies, drift, routed heads, the
encoder and checkpoints; ``fed.api.FederationPlan`` refuses a plan that
asks for one of them.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import server
from repro_torch.fed.plane import ServePlane, TauBuffer
from repro_torch.fed.policy import POLICIES, FoldPolicy, make_policy
from repro_torch.kernels.ref import SOLVE_ATTACH_DTYPES
from repro_torch.utils.prng import GumbelSource


class ReproPerfWarning(UserWarning):
    """A configuration costs performance without changing results (e.g.
    attach requests padded above the configured bucket ladder)."""


class StreamConfigError(ValueError):
    """A StreamConfig field failed validation (named, with accepted
    values), raised at construction."""


def _bad(fieldname: str, got, accepted: str) -> None:
    raise StreamConfigError(
        f"StreamConfig.{fieldname}={got!r} is invalid: {accepted}")


def bucket_of(n: int, ladder: Tuple[int, ...]) -> int:
    """The pad rung of an n-point request: the smallest ladder rung
    holding n points, doubling above the top rung."""
    for b in ladder:
        if n <= b:
            return int(b)
    b = int(ladder[-1])
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class StreamConfig:
    """Static configuration of the attachment service."""
    k: int                      # global cluster count of the round
    k_prime: int                # per-request k^(z) cap (static pad)
    d: int                      # feature dimension
    capacity: int               # fold-state slots (device ids)
    batch_size: int = 8         # requests per serve step
    bucket_sizes: Tuple[int, ...] = (64, 256, 1024)  # n^(z) pad buckets
    refresh_every: int = 0      # re-finalize after this many folds; 0 = never
    fold_reports: bool = True   # fold served reports into the server state
    weight_by_core_counts: bool = False
    fold_policy: str = "drop"
    serve_dtype: str = "f32"    # fused-step storage: f32 | bf16
    local_kw: dict = field(default_factory=dict)  # Algorithm 1 options

    def __post_init__(self):
        if not isinstance(self.k, int) or self.k < 1:
            _bad("k", self.k, "must be an int >= 1")
        if (not isinstance(self.k_prime, int)
                or not 1 <= self.k_prime <= self.k):
            _bad("k_prime", self.k_prime,
                 f"must satisfy 1 <= k_prime <= k (k={self.k})")
        if not isinstance(self.d, int) or self.d < 1:
            _bad("d", self.d, "must be an int >= 1")
        if self.capacity < 1:
            _bad("capacity", self.capacity, "must be an int >= 1")
        if self.batch_size < 1:
            _bad("batch_size", self.batch_size, "must be an int >= 1")
        if self.refresh_every < 0:
            _bad("refresh_every", self.refresh_every,
                 "must be >= 0 (0 disables the refresh cadence)")
        if (not self.bucket_sizes
                or any(int(b) < 1 for b in self.bucket_sizes)
                or list(self.bucket_sizes)
                != sorted(set(int(b) for b in self.bucket_sizes))):
            _bad("bucket_sizes", self.bucket_sizes,
                 "must be a non-empty strictly ascending tuple of "
                 "positive point-count pads, e.g. (64, 256, 1024)")
        if self.fold_policy not in POLICIES:
            _bad("fold_policy", self.fold_policy,
                 f"accepted values are {sorted(POLICIES)}")
        if self.serve_dtype not in SOLVE_ATTACH_DTYPES:
            _bad("serve_dtype", self.serve_dtype,
                 f"accepted values are {list(SOLVE_ATTACH_DTYPES)} (f32, "
                 "or bfloat16 storage with f32 accumulation)")


class AttachService:
    """Serves batches of late-joining devices against a finalized round.

    Construct with :meth:`_from_round` (seeds the fold state with the
    round's own reports) or directly from tau centers. ``gumbel`` keys
    each request's k-means++ draws by its request id (default: a
    ``GumbelSource`` of ``seed``)."""

    def __init__(self, cfg: StreamConfig, tau_centers, *,
                 state: Optional[server.ServerState] = None,
                 policy: Optional[FoldPolicy] = None, seed: int = 0,
                 gumbel: Optional[GumbelSource] = None, next_id: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.plane = ServePlane(cfg, device)
        self._taubuf = TauBuffer.fresh(self.plane.localize(tau_centers))
        if tuple(self._taubuf.bufs.shape) != (2, cfg.k, cfg.d):
            raise StreamConfigError(
                f"tau centers of shape {tuple(self._taubuf.tau.shape)} do "
                f"not match StreamConfig k={cfg.k}, d={cfg.d}")
        self.state = (server.init_state(cfg.capacity, cfg.k_prime, cfg.d,
                                        device=self.plane.device)
                      if state is None else state)
        self.policy = policy or make_policy(cfg.fold_policy, cfg.capacity)
        self._gumbel = gumbel or GumbelSource(seed)
        self._next_id = int(next_id)
        self._since_refresh = 0
        self._served_devices = 0
        self._served_points = 0
        self._pending: List[Tuple[int, np.ndarray, int]] = []
        # served, not yet delivered: rid -> (labels, tau version)
        self._done: Dict[int, tuple] = {}
        self._oversized_warned: set = set()

    @classmethod
    def _from_round(cls, rr, cfg: StreamConfig, *, seed: int = 0,
                    gumbel: Optional[GumbelSource] = None,
                    device="cuda") -> "AttachService":
        """Seed the service from a finished round: cache its tau centers
        and fold the participating devices' reports, so a later refresh
        re-finalizes over round + streamed devices."""
        Z = int(rr.device_centers.shape[0])
        if cfg.capacity < Z:
            raise StreamConfigError(
                f"StreamConfig.capacity={cfg.capacity} is invalid: the "
                f"drop policy needs a slot for each of the round's "
                f"{Z} devices")
        svc = cls(cfg, rr.agg.tau_centers, seed=seed, gumbel=gumbel,
                  next_id=Z, device=device)
        if cfg.fold_reports:
            ids = torch.nonzero(rr.participated.cpu()).reshape(-1)
            if ids.numel():
                idx = ids.to(svc.plane.device)
                cw = server.core_weights(rr.core_counts[idx])
                svc._admit_and_fold(
                    ids.numpy(), rr.device_centers[idx],
                    rr.center_mask[idx],
                    cw if cfg.weight_by_core_counts else None)
        return svc

    # ------------------------------------------------------------- serve --

    @property
    def tau(self) -> torch.Tensor:
        """The active tau buffer (what the serve step reads)."""
        return self._taubuf.tau

    @property
    def tau_version(self) -> int:
        return self._taubuf.version

    def submit(self, data, k_valid: Optional[int] = None) -> int:
        """Enqueue one device's (n, d) points; returns its request id (the
        fold slot, and the key of its k-means++ draws)."""
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        arr = np.asarray(data, np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.cfg.d:
            raise StreamConfigError(
                f"submit() takes (n, d={self.cfg.d}) points, got shape "
                f"{arr.shape}")
        kv = self.cfg.k_prime if k_valid is None else int(k_valid)
        if not 1 <= kv <= self.cfg.k_prime:
            raise StreamConfigError(
                f"submit() k_valid={kv} must be in [1, k_prime="
                f"{self.cfg.k_prime}]")
        rid = self._next_id
        self._next_id += 1
        self._pending.append((rid, arr, kv))
        return rid

    def _bucket(self, n: int) -> int:
        lad = tuple(self.cfg.bucket_sizes)
        b = bucket_of(n, lad)
        if n > lad[-1] and b not in self._oversized_warned:
            self._oversized_warned.add(b)
            warnings.warn(
                f"attach request with n={n} points exceeds the largest "
                f"configured bucket ({lad[-1]}); padding to an oversized "
                f"bucket of {b}. Add larger bucket_sizes to the plan to "
                f"avoid oversized pads.", ReproPerfWarning, stacklevel=3)
        return b

    def flush(self) -> Dict[int, np.ndarray]:
        """Serve every pending request; returns {request_id: (n,) labels}."""
        return {rid: lbl for rid, (lbl, _) in self._flush_all().items()}

    def flush_versioned(self) -> Dict[int, Tuple[np.ndarray, int]]:
        """Serve every pending request; returns
        {request_id: ((n,) labels, tau_version)}."""
        return self._flush_all()

    def _flush_all(self) -> Dict[int, tuple]:
        """Serve every pending request, grouped by pad bucket in fixed
        (batch_size, n_pad, d) shapes; a short batch pads by repeating
        its last real request (discarded). Two phases: first every batch
        is launched (serve step, fold, cadence refresh), then the labels
        are brought to the host."""
        pending, self._pending = self._pending, []
        buckets: Dict[int, list] = {}
        for item in pending:
            buckets.setdefault(self._bucket(item[1].shape[0]),
                               []).append(item)
        out, self._done = self._done, {}  # undelivered earlier results
        staged: List[tuple] = []
        B = self.cfg.batch_size
        try:
            for bucket in sorted(buckets):
                group = buckets[bucket]
                for lo in range(0, len(group), B):
                    self._serve_batch(group[lo:lo + B], bucket, staged)
            self._deliver(staged, out)
        except BaseException:
            # A failed batch must not lose work: batches that still
            # materialize are kept as undelivered results, and every
            # other request goes back on the queue by id.
            for entry in staged:
                if entry[0][0][0] in out:
                    continue
                try:
                    self._deliver([entry], out)
                except Exception:
                    pass  # its ids stay out of `out` and are requeued
            self._done.update(out)
            self._pending = [it for it in pending
                             if it[0] not in out] + self._pending
            raise
        return out

    def _deliver(self, staged, out) -> None:
        for batch, labels_dev, version in staged:
            labels = labels_dev.cpu().numpy()
            for i, (rid, arr, _) in enumerate(batch):
                out[rid] = (labels[i, :arr.shape[0]], version)
                self._served_devices += 1
                self._served_points += arr.shape[0]

    def serve(self, datas, k_valid=None) -> List[np.ndarray]:
        """Submit + flush: one labels array per input. Other requests
        already pending stay queued for the next :meth:`flush`."""
        return [lbl for lbl, _ in self.serve_versioned(datas, k_valid)]

    def serve_versioned(self, datas,
                        k_valid=None) -> List[Tuple[np.ndarray, int]]:
        """Like :meth:`serve`, returning (labels, tau_version) pairs."""
        kvs = [None] * len(datas) if k_valid is None else list(k_valid)
        if len(kvs) != len(datas):
            raise StreamConfigError(
                f"serve() got {len(datas)} requests and {len(kvs)} k_valid")
        rids = [self.submit(d, kv) for d, kv in zip(datas, kvs)]
        got = self._flush_all()
        mine = [got.pop(r) for r in rids]
        self._done.update(got)
        return mine

    def _serve_batch(self, batch, n_pad: int, staged) -> None:
        """Launch one batch's serve step and fold (and a cadence refresh)
        and stage its labels, still on the device."""
        cfg = self.cfg
        B = cfg.batch_size
        data = np.zeros((B, n_pad, cfg.d), np.float32)
        pmask = np.zeros((B, n_pad), bool)
        kv = np.full((B,), cfg.k_prime, np.int32)
        rids = np.zeros((B,), np.int64)
        for i in range(B):
            rid, arr, k_valid = batch[min(i, len(batch) - 1)]  # pad=repeat
            n = arr.shape[0]
            data[i, :n] = arr
            pmask[i, :n] = True
            kv[i] = k_valid
            rids[i] = rid
        dev = self.plane.device
        gumbel = self._gumbel.draw(rids.tolist(), cfg.k_prime, n_pad, dev)
        version = self._taubuf.version
        labels, centers, cmask, weights = self.plane.step(
            self.tau, gumbel, torch.from_numpy(data).to(dev),
            torch.from_numpy(pmask).to(dev), torch.from_numpy(kv).to(dev))
        if cfg.fold_reports:
            self._fold(batch, rids, centers, cmask, weights)
        staged.append((batch, labels, version))

    # -------------------------------------------------------------- fold --

    def _admit_and_fold(self, rids, centers, cmask, fold_w,
                        total: Optional[int] = None) -> int:
        """Admit a batch of reports through the policy and scatter the
        granted ones into their slots; padding rows and declined reports
        carry the out-of-capacity slot and are dropped. Returns the
        number of granted admissions (the refresh-cadence count)."""
        slots, granted = self.policy.admit_padded(rids, total=total)
        if granted:
            # Stamp each admitted slot with its request id.
            ep = np.zeros((len(slots),), np.int64)
            ep[:len(rids)] = np.asarray(rids, np.int64)
            dev = self.plane.device
            self.state = self.plane.fold(
                self.state, torch.from_numpy(slots).to(dev), centers, cmask,
                weights=fold_w, epochs=torch.from_numpy(ep).to(dev))
        return granted

    def _fold(self, batch, rids, centers, cmask, weights) -> None:
        admitted = self._admit_and_fold(
            rids[:len(batch)], centers, cmask,
            weights if self.cfg.weight_by_core_counts else None,
            total=len(rids))
        if not admitted:
            return
        self._since_refresh += admitted
        if (self.cfg.refresh_every
                and self._since_refresh >= self.cfg.refresh_every):
            self.refresh()

    # ----------------------------------------------------------- refresh --

    def refresh(self) -> server.KFedAggregate:
        """Finalize Algorithm 2 again over every folded report (round
        devices + streamed attachments) and swap the new tau in now: one
        atomic version bump."""
        agg = server.finalize(self.state, self.cfg.k,
                              weighted=self.cfg.weight_by_core_counts)
        self._taubuf = self._taubuf.swap_now(
            self.plane.localize(agg.tau_centers))
        self._since_refresh = 0
        return agg

    # ------------------------------------------------------------- stats --

    def stats(self) -> dict:
        return {
            "served_devices": self._served_devices,
            "served_points": self._served_points,
            "folded": int(torch.sum(self.state.received)),
            "capacity": self.cfg.capacity,
            "fold_policy": self.policy.name,
            "pending": len(self._pending),
            "undelivered": len(self._done),
            "since_refresh": self._since_refresh,
            "tau_version": self._taubuf.version,
            "refresh_pending": self._taubuf.pending,
            **self.plane.describe(),
        }
