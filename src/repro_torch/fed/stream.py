"""The streaming attachment service (counterpart of
``repro/fed/stream.py``).

After the one round, Theorem 3.2 attaches any late device in O(k'k)
with no extra round. This service batches such requests: they are
bucketed by padded point count, padded into fixed ``(B, n_pad, d)``
shapes with point masks and served by the plane's step. A request's
k-means++ draws depend on its own request id only, so batching never
changes its labels.

  * **Folding and refresh**: each served report can be folded into the
    incremental server state through an admission policy
    (``fed/policy.py``: ``drop``, ``lru`` or ``weighted_reservoir``),
    and every ``refresh_every`` granted admissions the round is
    finalized again so tau tracks the population. tau is double-buffered
    and versioned (``fed/plane.TauBuffer``): ``refresh="sync"`` swaps at
    once, between batches; ``refresh="async"`` stages the standby
    buffer on the current stream without waiting for it and commits the
    swap, one version bump, at the next flush boundary. Every served
    label carries the version that produced it.
  * **Autoscaling** (``fed/autoscale.py``): at each flush boundary a
    deterministic controller may re-select the active shard count
    (within the plane's ``serve_axes`` grant), the batch rung and the
    active bucket ladder from the queue's depth and histogram; each
    bucket group right-sizes its batch to ``min(rung, pow2_ceil(len))``
    and its shard count to what that batch divides over.
  * **Sharded serving** (``serve_axes`` and a ``utils.mesh.Mesh``): every
    rank runs this service on the same requests; the plane splits each
    batch over the ranks and gathers the labels, and the fold state and
    tau stay the same bits on every rank. Rank 0 writes the checkpoint.
  * **Routed heads** (DESIGN.md §16): with ``heads`` on every batch goes
    through the plane's routed step, on one device or sharded: the same
    labels, plus one prediction per request from the head of its
    majority-vote cluster (``flush_predict`` / ``serve_predict``).
  * **Drift** (DESIGN.md §14): with ``drift="decay"`` a refresh weights
    every fold slot by 2^(-age/half_life), age in requests since its
    fold, and masks out the fully decayed; ``"split_merge"`` then
    re-seeds starved centers from over-massed ones. A re-seeded
    center's head starts as a copy of its donor's: the re-map is staged
    at the refresh and committed with the tau swap that bumps the
    version (at once on a sync refresh, at the next flush boundary on an
    async one). Every decision is a function of the folded stream, so
    it replays from a checkpoint.
  * **Ingestion encoder** (DESIGN.md §17): with ``encoder`` on, each
    request is (n, seq, d) raw token sequences, ``1 <= seq <=
    encode_seq_len``. Requests group by (point-count rung, sequence rung)
    and the plane encodes each batch on the device ahead of the
    unchanged step (routed or not, sharded or not); folds, refreshes,
    drift and autoscaling work on the embeddings.
  * **Checkpoints**: ``save`` writes the serving state in the JAX
    package's npz schema and ``_restore`` reads the archives of schemas
    v1-v6 (see ``_restore``); restore then serve replays labels,
    versions and decisions exactly.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import (decode_tag, encode_tag,
                                         load_extras, load_pytree,
                                         save_pytree)
from repro_torch.core import server
from repro_torch.fed.autoscale import (AUTOSCALE_IDS, AUTOSCALE_POLICIES,
                                       AutoscaleController, FlushTelemetry,
                                       bucket_of, pow2_ceil, shards_for,
                                       snapshot_queue)
from repro_torch.fed.plane import (ServePlane, ServePlaneError, TauBuffer,
                                   route_capacity)
from repro_torch.fed.policy import (POLICIES, POLICY_IDS, FoldPolicy,
                                    make_policy)
from repro_torch.kernels.ref import SOLVE_ATTACH_DTYPES
from repro_torch.models import encoder as enc_mod
from repro_torch.models import heads as heads_mod
from repro_torch.utils.prng import GumbelSource


class ReproPerfWarning(UserWarning):
    """A configuration costs performance without changing results (e.g.
    attach requests padded above the configured bucket ladder)."""


class StreamConfigError(ValueError):
    """A StreamConfig field failed validation (named, with accepted
    values), raised at construction."""


class ServedPrediction(NamedTuple):
    """One request's routed-serving result: its labels and the tau
    version that produced them (the pair :meth:`AttachService.
    flush_versioned` gives), plus its cluster head's pooled prediction.
    ``routed=False`` marks a request that overflowed its cluster's
    dispatch queue: it has labels and a ``cluster``, and a zero
    ``prediction``."""
    labels: np.ndarray        # (n,) int32 per-point labels
    tau_version: int
    prediction: np.ndarray    # (d,) f32 pooled head output
    cluster: int              # majority-vote cluster (the head index)
    routed: bool              # False = dispatch-queue overflow


# Salt of the head-init stream, apart from the per-request draws (which
# are keyed by request id).
_HEADS_SALT = 0x48454144  # "HEAD"

# Salt of the encoder-init stream, apart from the head stream, so that
# turning one on never re-keys the other.
_ENCODER_SALT = 0x454E434F  # "ENCO"

# The smallest token-axis pad rung: sequences pad to powers of two from
# here up to ``encode_seq_len``, so the (n_pad, seq_pad) shapes a plan
# serves form a small fixed grid.
_SEQ_RUNG_FLOOR = 8

REFRESH_MODES = ("sync", "async")

DRIFT_MODES = ("off", "decay", "split_merge")

# The JAX package's numeric codes of the drift modes, as a checkpoint
# (schema v4+) stores them: its fold epochs, mass histogram and
# split/retire counters mean something only under the mode that wrote
# them.
DRIFT_IDS = {"off": 0, "decay": 1, "split_merge": 2}


class _ServerStateV3(NamedTuple):
    """Restore template for pre-v4 archives: the fold state before the
    drift layer's epoch stamps, under the same key paths
    ("server/.centers" ...)."""
    centers: torch.Tensor
    mask: torch.Tensor
    weights: torch.Tensor
    received: torch.Tensor


def _encoder_tag(cfg) -> str:
    """What a schema v6 archive stores of the encoder's configuration."""
    return f"{cfg.encoder}|{cfg.encode_dtype}|{cfg.encode_seq_len}"


def _bad(fieldname: str, got, accepted: str) -> None:
    raise StreamConfigError(
        f"StreamConfig.{fieldname}={got!r} is invalid: {accepted}")


@dataclass(frozen=True)
class StreamConfig:
    """Static configuration of the attachment service."""
    k: int                      # global cluster count of the round
    k_prime: int                # per-request k^(z) cap (static pad)
    d: int                      # feature dimension
    capacity: int               # fold-state slots (device ids)
    batch_size: int = 8         # requests per serve step (autoscale: cap)
    bucket_sizes: Tuple[int, ...] = (64, 256, 1024)  # n^(z) pad buckets
    refresh_every: int = 0      # re-finalize after this many folds; 0 = never
    refresh: str = "sync"       # tau swap: sync (at once) | async
    autoscale: str = "off"      # off | latency | throughput
    fold_reports: bool = True   # fold served reports into the server state
    weight_by_core_counts: bool = False
    fold_policy: str = "drop"   # admission: drop | lru | weighted_reservoir
    policy_seed: int = 0        # weighted_reservoir key seed
    serve_dtype: str = "f32"    # fused-step storage: f32 | bf16
    drift: str = "off"          # drift adaptation: off|decay|split_merge
    drift_half_life: int = 0    # decay half-life in requests (>= 1 on)
    drift_split_factor: float = 2.0   # split centers above this x mean mass
    drift_retire_frac: float = 0.1    # retire centers below this x mean mass
    drift_max_moves: int = 1    # split/retire moves per flush boundary
    heads: str = "off"          # per-cluster serving heads: off|linear|<config>
    head_capacity: float = 1.25  # dispatch queue slots per cluster, x B/k
    head_arch: str = "ffn"      # head architecture: ffn | transformer
    encoder: str = "off"        # ingestion encoder: off | <config name>
    encode_dtype: str = "f32"   # encoder storage: f32 | bf16 (f32 accum)
    encode_seq_len: int = 64    # token-axis pad ceiling per point
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
        if self.refresh not in REFRESH_MODES:
            _bad("refresh", self.refresh,
                 f"accepted values are {list(REFRESH_MODES)}")
        if self.autoscale not in AUTOSCALE_POLICIES:
            _bad("autoscale", self.autoscale,
                 f"accepted values are {list(AUTOSCALE_POLICIES)}")
        if (self.autoscale != "off"
                and self.batch_size & (self.batch_size - 1)):
            _bad("batch_size", self.batch_size,
                 "must be a power of two when autoscale is enabled (the "
                 "controller re-selects power-of-two batch rungs within "
                 "it)")
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
        if not isinstance(self.policy_seed, int) or self.policy_seed < 0:
            _bad("policy_seed", self.policy_seed,
                 "must be a non-negative int (seeds the "
                 "weighted_reservoir keys)")
        if self.drift not in DRIFT_MODES:
            _bad("drift", self.drift,
                 f"accepted values are {list(DRIFT_MODES)}")
        if self.drift != "off" and (
                not isinstance(self.drift_half_life, int)
                or self.drift_half_life < 1):
            _bad("drift_half_life", self.drift_half_life,
                 "must be an int >= 1 (requests) when drift is enabled")
        if not float(self.drift_split_factor) > 1.0:
            _bad("drift_split_factor", self.drift_split_factor,
                 "must be > 1.0 (multiples of the mean center mass)")
        if not 0.0 <= float(self.drift_retire_frac) < 1.0:
            _bad("drift_retire_frac", self.drift_retire_frac,
                 "must be in [0.0, 1.0) (fraction of the mean mass)")
        if (not isinstance(self.drift_max_moves, int)
                or self.drift_max_moves < 1):
            _bad("drift_max_moves", self.drift_max_moves,
                 "must be an int >= 1 (split/retire moves per boundary)")
        if self.serve_dtype not in SOLVE_ATTACH_DTYPES:
            _bad("serve_dtype", self.serve_dtype,
                 f"accepted values are {list(SOLVE_ATTACH_DTYPES)} (f32, "
                 "or bfloat16 storage with f32 accumulation)")
        if not (isinstance(self.head_capacity, (int, float))
                and float(self.head_capacity) > 0.0):
            _bad("head_capacity", self.head_capacity,
                 "must be a float > 0 (per-cluster dispatch queue slots "
                 "as a multiple of batch_size / k; requests past a "
                 "cluster's queue are served labels without a "
                 "prediction)")
        if self.heads != "off":
            if self.head_arch not in heads_mod.HEAD_ARCHS:
                _bad("head_arch", self.head_arch,
                     f"accepted values are {list(heads_mod.HEAD_ARCHS)}")
            try:
                heads_mod.resolve_head_spec(self.heads, self.head_arch,
                                            self.d)
            except heads_mod.HeadConfigError as e:
                _bad("heads", self.heads, str(e))
        if self.encode_dtype not in enc_mod.ENCODE_DTYPES:
            _bad("encode_dtype", self.encode_dtype,
                 f"accepted values are {list(enc_mod.ENCODE_DTYPES)} (f32 "
                 "keeps the encode stage bitwise-reproducible across "
                 "restores; bf16 stores encoder params/activations in "
                 "bfloat16 with f32 accumulation — DESIGN.md §17)")
        if self.encoder != "off":
            if (not isinstance(self.encode_seq_len, int)
                    or self.encode_seq_len < 1):
                _bad("encode_seq_len", self.encode_seq_len,
                     "must be an int >= 1 (the per-point token-sequence "
                     "pad ceiling) when the encoder is enabled")
            try:
                enc_mod.resolve_encoder_spec(self.encoder, self.d)
            except enc_mod.EncoderConfigError as e:
                _bad("encoder", self.encoder, str(e))

    def encoder_spec(self) -> Optional[enc_mod.EncoderSpec]:
        """The resolved encoder spec (None when the encoder is off)."""
        if self.encoder == "off":
            return None
        return enc_mod.resolve_encoder_spec(self.encoder, self.d)

    def head_spec(self) -> Optional[heads_mod.HeadSpec]:
        """The resolved head spec (None when heads are off)."""
        if self.heads == "off":
            return None
        return heads_mod.resolve_head_spec(self.heads, self.head_arch,
                                           self.d)

    def policy_half_life(self) -> int:
        """The fold policy's decay half-life: the drift one, 0 with
        drift off (the weighted reservoir's key then does not decay)."""
        return self.drift_half_life if self.drift != "off" else 0


class AttachService:
    """Serves batches of late-joining devices against a finalized round.

    Construct with :meth:`_from_round` (seeds the fold state with the
    round's own reports) or directly from tau centers. ``gumbel`` keys
    each request's k-means++ draws by its request id (default: a
    ``GumbelSource`` of ``seed``). With ``cfg.heads`` on, ``heads`` are
    the per-cluster head parameters (``models.heads.init_heads``
    layout); by default they are drawn from ``seed`` on a salted
    stream. With ``cfg.encoder`` on, ``encoder`` is the ingestion
    encoder's parameters (``models.encoder.init_encoder`` layout), by
    default drawn from ``seed`` on a stream of its own salt. A restore
    (:meth:`_restore`) hands in the archive's tau buffer, fold state and
    counters. ``mesh`` and ``serve_axes`` shard
    the serve plane (DESIGN.md §11): per request the labels are the
    single-device plane's bit for bit for a fixed tau version."""

    def __init__(self, cfg: StreamConfig, tau_centers, *,
                 state: Optional[server.ServerState] = None,
                 policy: Optional[FoldPolicy] = None, seed: int = 0,
                 gumbel: Optional[GumbelSource] = None, next_id: int = 0,
                 since_refresh: int = 0, served_devices: int = 0,
                 served_points: int = 0,
                 tau_buffer: Optional[TauBuffer] = None,
                 heads=None, encoder=None, device="cuda", mesh=None,
                 serve_axes=None):
        self.cfg = cfg
        try:
            self.plane = ServePlane(cfg, device, mesh=mesh,
                                    serve_axes=serve_axes)
        except ServePlaneError as e:
            raise StreamConfigError(str(e)) from None
        self._taubuf = (TauBuffer.fresh(self.plane.localize(tau_centers))
                        if tau_buffer is None else tau_buffer._replace(
                            bufs=self.plane.localize(tau_buffer.bufs)))
        if tuple(self._taubuf.bufs.shape) != (2, cfg.k, cfg.d):
            raise StreamConfigError(
                f"tau centers of shape {tuple(self._taubuf.tau.shape)} do "
                f"not match StreamConfig k={cfg.k}, d={cfg.d}")
        self.state = (server.init_state(cfg.capacity, cfg.k_prime, cfg.d,
                                        device=self.plane.device)
                      if state is None else state)
        self.policy = policy or make_policy(
            cfg.fold_policy, cfg.capacity, seed=cfg.policy_seed,
            half_life=cfg.policy_half_life())
        # The flush-boundary controller: one decision a non-empty flush,
        # against the shards serve_axes granted. With autoscale "off" its
        # static decision is the whole grant, the plan's batch and ladder.
        self.autoscaler = AutoscaleController(
            cfg.autoscale, max_batch=cfg.batch_size,
            granted=self.plane.n_shards,
            n_axes=len(self.plane.axes) if self.plane.axes else 1,
            base_ladder=tuple(cfg.bucket_sizes))
        self._base_seed = int(seed)
        self._gumbel = gumbel or GumbelSource(seed)
        self._next_id = int(next_id)
        self._since_refresh = int(since_refresh)
        self._served_devices = int(served_devices)
        self._served_points = int(served_points)
        self._pending: List[Tuple[int, np.ndarray, int]] = []
        # served, not yet delivered: rid -> (labels, tau version,
        # (prediction, cluster, routed) | None with heads off)
        self._done: Dict[int, tuple] = {}
        self._oversized_warned: set = set()
        self._head_spec = cfg.head_spec()
        # A split/retire head re-map staged by a refresh, applied with
        # the tau swap that bumps the version (_commit_heads_perm).
        self._heads_perm: Optional[np.ndarray] = None
        self._routed_served = 0
        self._overflowed = 0
        # The drift state (schema v4): each center's decayed fold mass at
        # the last refresh and the split/retire counters, functions of
        # the folded stream only.
        self._drift_mass = np.zeros((cfg.k,), np.float32)
        self._drift_events = 0    # refreshes that moved >= 1 center
        self._drift_moves = 0     # split/retire moves in all
        self._drift_last = 0      # moves at the latest refresh
        if self._head_spec is None:
            self.heads = None
        elif heads is not None:
            self.heads = heads_mod.tree_map(self.plane.localize, heads)
        else:
            head_seed = np.random.SeedSequence(
                [int(seed), _HEADS_SALT]).generate_state(1, np.uint64)[0]
            gen = torch.Generator(device="cpu").manual_seed(int(head_seed))
            self.heads = heads_mod.init_heads(gen, cfg.k, self._head_spec,
                                              device=self.plane.device)
        self._enc_spec = cfg.encoder_spec()
        self._encoded_points = 0
        if self._enc_spec is None:
            self.encoder = None
        elif encoder is not None:
            self.encoder = heads_mod.tree_map(self.plane.localize, encoder)
        else:
            enc_seed = np.random.SeedSequence(
                [int(seed), _ENCODER_SALT]).generate_state(1, np.uint64)[0]
            gen = torch.Generator(device="cpu").manual_seed(int(enc_seed))
            self.encoder = enc_mod.init_encoder(gen, self._enc_spec,
                                                device=self.plane.device)

    @classmethod
    def _from_round(cls, rr, cfg: StreamConfig, *, seed: int = 0,
                    gumbel: Optional[GumbelSource] = None, heads=None,
                    encoder=None, device="cuda", mesh=None,
                    serve_axes=None) -> "AttachService":
        """Seed the service from a finished round: cache its tau centers
        and fold the participating devices' reports, so a later refresh
        re-finalizes over round + streamed devices."""
        Z = int(rr.device_centers.shape[0])
        if cfg.fold_policy == "drop" and cfg.capacity < Z:
            raise StreamConfigError(
                f"StreamConfig.capacity={cfg.capacity} is invalid: the "
                f"drop policy needs a slot for each of the round's "
                f"{Z} devices")
        svc = cls(cfg, rr.agg.tau_centers, seed=seed, gumbel=gumbel,
                  next_id=Z, heads=heads, encoder=encoder, device=device,
                  mesh=mesh, serve_axes=serve_axes)
        if cfg.fold_reports:
            ids = torch.nonzero(rr.participated.cpu()).reshape(-1)
            if ids.numel():
                idx = ids.to(svc.plane.device)
                cw = server.core_weights(rr.core_counts[idx])
                dev_w = (torch.sum(cw, dim=1).cpu().numpy()
                         if svc.policy.needs_weight else None)
                svc._admit_and_fold(
                    ids.numpy(), dev_w, rr.device_centers[idx],
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
        """Enqueue one device's (n, d) points, or with the encoder on its
        (n, seq, d) raw token sequences, ``1 <= seq <= encode_seq_len``;
        returns its request id (the fold slot, and the key of its
        k-means++ draws)."""
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        arr = np.asarray(data, np.float32)
        if self._enc_spec is None:
            if arr.ndim != 2 or arr.shape[1] != self.cfg.d:
                raise StreamConfigError(
                    f"submit() takes (n, d={self.cfg.d}) points, got shape "
                    f"{arr.shape}")
        else:
            if arr.ndim != 3 or arr.shape[2] != self.cfg.d:
                raise StreamConfigError(
                    f"submit() takes (n, seq, d={self.cfg.d}) token "
                    f"sequences with encoder={self.cfg.encoder!r}, got "
                    f"shape {arr.shape}")
            if arr.shape[1] < 1 or arr.shape[1] > self.cfg.encode_seq_len:
                raise StreamConfigError(
                    f"submit() got a token sequence of length "
                    f"{arr.shape[1]}: with encoder="
                    f"{self.cfg.encoder!r} every point must carry "
                    f"1 <= seq <= encode_seq_len="
                    f"{self.cfg.encode_seq_len} tokens (raise "
                    f"encode_seq_len in the plan for longer inputs)")
        kv = self.cfg.k_prime if k_valid is None else int(k_valid)
        if not 1 <= kv <= self.cfg.k_prime:
            raise StreamConfigError(
                f"submit() k_valid={kv} must be in [1, k_prime="
                f"{self.cfg.k_prime}]")
        rid = self._next_id
        self._next_id += 1
        self._pending.append((rid, arr, kv))
        return rid

    def _bucket(self, n: int, ladder: Tuple[int, ...]) -> int:
        """The pad rung of an n-point request under the flush decision's
        active ladder (autoscale may have coalesced the oversized rungs);
        each distinct oversized (ladder, rung) warns once."""
        top = self.cfg.bucket_sizes[-1]
        b = bucket_of(n, tuple(ladder))
        key = (tuple(ladder), b)
        if n > top and key not in self._oversized_warned:
            self._oversized_warned.add(key)
            warnings.warn(
                f"attach request with n={n} points exceeds the largest "
                f"configured bucket ({top}); padding to an oversized "
                f"bucket of {b}. Add larger bucket_sizes to the plan to "
                f"avoid oversized pads.", ReproPerfWarning, stacklevel=3)
        return b

    def _seq_rung(self, seq: int) -> int:
        """The token-axis pad rung of a request: the next power of two,
        at least ``_SEQ_RUNG_FLOOR``, at most ``encode_seq_len``."""
        return min(int(self.cfg.encode_seq_len),
                   max(_SEQ_RUNG_FLOOR, pow2_ceil(seq)))

    def _bucket_key(self, arr: np.ndarray, ladder: Tuple[int, ...]):
        """The flush-group key of a request: its point-count rung with
        the encoder off, the (n_pad, seq_pad) pair with it on. Keys of
        one plan are of one kind, so the groups sort alike either way."""
        n_pad = self._bucket(arr.shape[0], ladder)
        if self._enc_spec is None:
            return n_pad
        return (n_pad, self._seq_rung(arr.shape[1]))

    def flush(self) -> Dict[int, np.ndarray]:
        """Serve every pending request; returns {request_id: (n,) labels}."""
        return {rid: lbl for rid, (lbl, _, _) in self._flush_all().items()}

    def flush_versioned(self) -> Dict[int, Tuple[np.ndarray, int]]:
        """Serve every pending request; returns
        {request_id: ((n,) labels, tau_version)}."""
        return {rid: (lbl, ver)
                for rid, (lbl, ver, _) in self._flush_all().items()}

    def _require_heads(self, method: str) -> None:
        if self._head_spec is None:
            raise StreamConfigError(
                f"{method}() needs per-cluster serving heads: set "
                f"StreamConfig.heads to 'linear' or a registered model "
                f"config (it is 'off')")

    def flush_predict(self) -> Dict[int, ServedPrediction]:
        """Serve every pending request through the routed step; returns
        {request_id: :class:`ServedPrediction`}. Labels and tau versions
        are the ones :meth:`flush_versioned` would have returned."""
        self._require_heads("flush_predict")
        return {rid: ServedPrediction(lbl, ver, *pred)
                for rid, (lbl, ver, pred) in self._flush_all().items()}

    def _flush_all(self) -> Dict[int, tuple]:
        """Serve every pending request; returns {request_id: (labels,
        tau_version, pred)}, ``pred`` = (prediction, cluster, routed)
        with heads on, else None.

        The flush boundary is where a staged async tau swap commits (with
        any split/retire head re-map staged beside it) and where the
        autoscale decision is taken, from a snapshot of the queue (under
        drift it carries the last refresh's mass histogram). Requests are grouped by pad bucket under the decision's
        ladder and served in fixed (B, n_pad, d) shapes; a short batch
        pads by repeating its last real request (discarded). Two phases:
        first every batch is launched (serve or routed step, fold,
        cadence refresh), then the results are brought to the host."""
        if self._taubuf.pending:
            self._taubuf = self._taubuf.commit()
            self._commit_heads_perm()
        pending, self._pending = self._pending, []
        decision = self.autoscaler.decision
        if pending and self.cfg.autoscale != "off":
            decision = self.autoscaler.observe(snapshot_queue(
                [item[1].shape[0] for item in pending],
                self.cfg.bucket_sizes,
                mass=(self._drift_mass if self.cfg.drift != "off"
                      else ())))
        buckets: Dict[object, list] = {}
        for item in pending:
            buckets.setdefault(self._bucket_key(item[1], decision.ladder),
                               []).append(item)
        out, self._done = self._done, {}  # undelivered earlier results
        staged: List[tuple] = []
        B = decision.batch_size
        t0 = time.perf_counter()
        try:
            for bucket in sorted(buckets):
                group = buckets[bucket]
                for lo in range(0, len(group), B):
                    self._serve_batch(group[lo:lo + B], bucket, B,
                                      decision.shards, staged)
            t1 = time.perf_counter()
            self._deliver(staged, out)
            if pending:
                self.autoscaler.record(FlushTelemetry(
                    dispatch_us=int((t1 - t0) * 1e6),
                    materialize_us=int((time.perf_counter() - t1) * 1e6),
                    batches=len(staged), requests=len(pending),
                    points=sum(item[1].shape[0] for item in pending)))
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
        """Phase 2 of a flush: bring each launched batch's labels (and,
        with heads on, predictions) to the host."""
        for batch, labels_dev, version, routed_dev in staged:
            labels = labels_dev.cpu().numpy()
            if routed_dev is not None:
                preds, cl, kept = (t.cpu().numpy() for t in routed_dev)
            for i, (rid, arr, _) in enumerate(batch):
                pred = None
                if routed_dev is not None:
                    pred = (preds[i].copy(), int(cl[i]), bool(kept[i]))
                    self._routed_served += int(kept[i])
                    self._overflowed += int(not kept[i])
                out[rid] = (labels[i, :arr.shape[0]], version, pred)
                self._served_devices += 1
                self._served_points += arr.shape[0]

    def serve(self, datas, k_valid=None) -> List[np.ndarray]:
        """Submit + flush: one labels array per input. Other requests
        already pending stay queued for the next :meth:`flush`."""
        return [lbl for lbl, _, _ in self._serve_all(datas, k_valid)]

    def serve_versioned(self, datas,
                        k_valid=None) -> List[Tuple[np.ndarray, int]]:
        """Like :meth:`serve`, returning (labels, tau_version) pairs."""
        return [(lbl, ver) for lbl, ver, _ in self._serve_all(datas, k_valid)]

    def serve_predict(self, datas, k_valid=None) -> List[ServedPrediction]:
        """Submit + flush through the per-cluster heads: one
        :class:`ServedPrediction` per input (the labels and versions of
        :meth:`serve_versioned`)."""
        self._require_heads("serve_predict")
        return [ServedPrediction(lbl, ver, *pred)
                for lbl, ver, pred in self._serve_all(datas, k_valid)]

    def _serve_all(self, datas, k_valid) -> List[tuple]:
        kvs = [None] * len(datas) if k_valid is None else list(k_valid)
        if len(kvs) != len(datas):
            raise StreamConfigError(
                f"serve() got {len(datas)} requests and {len(kvs)} k_valid")
        rids = [self.submit(d, kv) for d, kv in zip(datas, kvs)]
        got = self._flush_all()
        mine = [got.pop(r) for r in rids]
        self._done.update(got)
        return mine

    def _serve_batch(self, batch, bucket, B: int, shards: int,
                     staged) -> None:
        """Launch one batch's serve step and fold (and a cadence refresh)
        at the flush decision's (shards, batch) and stage its labels,
        still on the device. ``bucket`` is the group's key: the
        point-count rung, or with the encoder on the (n_pad, seq_pad)
        pair, whose batch of raw sequences the plane encodes ahead of
        the step. Under autoscale the batch right-sizes to
        ``min(rung, pow2_ceil(len(batch)))``, a function of the group's
        size alone, so a replay cuts the same batches, and the shard
        count follows it down (``shards_for``). Nothing here waits for
        the device, except a ``needs_weight`` policy's one copy of the
        report weights."""
        cfg = self.cfg
        encoded = self._enc_spec is not None
        n_pad, s_pad = bucket if encoded else (bucket, 0)
        if cfg.autoscale != "off":
            B = min(B, pow2_ceil(len(batch)))
            shards = shards_for(B, shards, self.autoscaler.n_axes)
        if encoded:
            data = np.zeros((B, n_pad, s_pad, cfg.d), np.float32)
            tmask = np.zeros((B, n_pad, s_pad), bool)
        else:
            data = np.zeros((B, n_pad, cfg.d), np.float32)
        pmask = np.zeros((B, n_pad), bool)
        kv = np.full((B,), cfg.k_prime, np.int32)
        rids = np.zeros((B,), np.int64)
        for i in range(B):
            rid, arr, k_valid = batch[min(i, len(batch) - 1)]  # pad=repeat
            n = arr.shape[0]
            if encoded:
                data[i, :n, :arr.shape[1]] = arr
                tmask[i, :n, :arr.shape[1]] = True
            else:
                data[i, :n] = arr
            pmask[i, :n] = True
            kv[i] = k_valid
            rids[i] = rid
        version = self._taubuf.version
        heads = self._head_spec is not None
        if encoded:
            self._encoded_points += sum(item[1].shape[0] for item in batch)
        step = {(False, False): self.plane.step,
                (False, True): self.plane.routed_step,
                (True, False): self.plane.encode_step,
                (True, True): self.plane.encoded_routed_step}[encoded, heads]
        params = ((self.tau,) + ((self.encoder,) if encoded else ())
                  + ((self.heads,) if heads else ()))
        out = step(*params, self._gumbel, rids, data, pmask,
                   *((tmask,) if encoded else ()), kv, shards=shards)
        labels, centers, cmask, weights = out[:4]
        routed = tuple(out[4:]) or None
        if cfg.fold_reports:
            self._fold(batch, rids, centers, cmask, weights, shards)
        staged.append((batch, labels, version, routed))

    # -------------------------------------------------------------- fold --

    def _admit_and_fold(self, rids, dev_w, centers, cmask, fold_w,
                        total: Optional[int] = None,
                        shards: Optional[int] = None) -> int:
        """Admit a batch of reports through the policy (``dev_w``: each
        report's core-set mass, for a ``needs_weight`` policy) and
        scatter the granted ones into their slots; padding rows and
        declined reports carry the out-of-capacity slot and are dropped.
        ``shards``: the step's active shard count, whose rows of the
        reports this rank holds (None: the whole batch, the round's
        seeding). Returns the number of granted admissions (the
        refresh-cadence count)."""
        slots, granted = self.policy.admit_padded(rids, dev_w, total=total)
        if granted:
            # Stamp each admitted slot with its request id.
            ep = np.zeros((len(slots),), np.int64)
            ep[:len(rids)] = np.asarray(rids, np.int64)
            dev = self.plane.device
            self.state = self.plane.fold(
                self.state, torch.from_numpy(slots).to(dev), centers, cmask,
                weights=fold_w, epochs=torch.from_numpy(ep).to(dev),
                shards=shards)
        return granted

    def _fold(self, batch, rids, centers, cmask, weights, shards) -> None:
        # The reservoir's keys need each report's mass on the host: one
        # copy a batch, summed over the axis the JAX package sums over.
        dev_w = (self.plane.gather_rows(torch.sum(weights, dim=1), shards)
                 .cpu().numpy()[:len(batch)]
                 if self.policy.needs_weight else None)
        admitted = self._admit_and_fold(
            rids[:len(batch)], dev_w, centers, cmask,
            weights if self.cfg.weight_by_core_counts else None,
            total=len(rids), shards=shards)
        if not admitted:
            return
        self._since_refresh += admitted
        if (self.cfg.refresh_every
                and self._since_refresh >= self.cfg.refresh_every):
            if self.cfg.refresh == "sync":
                self.refresh()
            else:
                self._stage_refresh()

    # ----------------------------------------------------------- refresh --

    def _refinalize(self):
        """Algorithm 2 again over every folded report (round devices and
        streamed attachments), the sync and the async refresh alike,
        with the drift layer on top when the plan asks for it:

          * ``drift="off"``: the plain finalize;
          * ``"decay"``: every slot weighted by its age factor, the
            fully decayed masked out (``server.finalize(decay=)``), and
            the per-center mass recomputed;
          * ``"split_merge"``: then ``server.split_retire`` re-seeds
            starved centers from over-massed ones and re-anchors with
            one Lloyd round; its move count is one copy to the host.
            With heads on, a re-seeded center's head is staged to start
            as a copy of its donor's.

        Returns ``(agg, tau)``: the tau to swap in."""
        cfg = self.cfg
        self._since_refresh = 0
        if cfg.drift == "off":
            agg = server.finalize(self.state, cfg.k,
                                  weighted=cfg.weight_by_core_counts)
            return agg, agg.tau_centers
        decay = (self._next_id, cfg.drift_half_life)
        agg = server.finalize(self.state, cfg.k, decay=decay)
        mask, w = server.decayed_evidence(self.state, *decay)
        mass = server.center_mass(agg, mask, w)
        tau = agg.tau_centers
        if cfg.drift == "split_merge":
            # Masked slots carry no evidence: their coordinates stay out
            # of the re-seed distances and the Lloyd round, as finalize
            # keeps them out.
            flat = torch.where(mask[..., None], self.state.centers,
                               torch.zeros_like(self.state.centers)
                               ).reshape(-1, cfg.d).float()
            tau, take, donors, n_mv = server.split_retire(
                flat, mask.reshape(-1), agg, mass, cfg.k,
                split_factor=cfg.drift_split_factor,
                retire_frac=cfg.drift_retire_frac,
                max_moves=cfg.drift_max_moves, weights=w.reshape(-1))
            moves = int(n_mv)
            self._drift_events += 1 if moves else 0
            self._drift_moves += moves
            self._drift_last = moves
            if moves and self._head_spec is not None:
                # Overwritten, not composed: donors index the current
                # heads, and an earlier staged re-map was committed with
                # its own tau swap.
                perm = np.arange(cfg.k, dtype=np.int64)
                tk = take.cpu().numpy()
                perm[tk] = donors.cpu().numpy()[tk]
                self._heads_perm = perm
        self._drift_mass = mass.cpu().numpy().astype(np.float32)
        return agg, tau

    def refresh(self) -> server.KFedAggregate:
        """Finalize Algorithm 2 again and swap the new tau in now: one
        atomic version bump (with any staged head re-map)."""
        agg, tau = self._refinalize()
        self._taubuf = self._taubuf.swap_now(self.plane.localize(tau))
        self._commit_heads_perm()
        return agg

    def _stage_refresh(self) -> None:
        """The async refresh: finalize into the standby buffer, enqueued
        on the current stream without waiting for it (a split/retire
        refresh waits once, for its move count), so the batches behind
        it keep serving the active tau; the swap (one version bump)
        commits at the next flush boundary."""
        _, tau = self._refinalize()
        self._taubuf = self._taubuf.stage(self.plane.localize(tau))

    def _commit_heads_perm(self) -> None:
        """Apply a staged split/retire head re-map: the partner of the
        tau swap that staged it."""
        perm, self._heads_perm = self._heads_perm, None
        if perm is None or self._head_spec is None:
            return
        idx = torch.as_tensor(perm, device=self.plane.device)
        self.heads = heads_mod.tree_map(lambda p: p[idx], self.heads)

    # -------------------------------------------------------- checkpoint --

    def _counters(self) -> np.ndarray:
        return np.asarray([self._next_id, self._since_refresh,
                           self._served_devices, self._served_points,
                           self._base_seed], np.int64)

    def save(self, path: str) -> str:
        """Checkpoint the serving state in the JAX package's schema: both
        tau buffers, their version and whether a swap is staged, the
        fold state, the counters, the admission policy's id and state,
        the autoscale controller's id and decision state (schema v3),
        the drift mode, its counters and mass histogram (schema v4; the
        fold epochs ride in the state), and with heads on (schema v5)
        the head parameters, their tag, the routed counters and a staged
        head re-map, and with the encoder on (schema v6) the encoder
        parameters, their ``encoder|encode_dtype|encode_seq_len`` tag and
        the encoded-point counter. A restore in either package replays
        the labels, tau versions, scaling and split/retire decisions.
        Pending requests are not stored. On a mesh, rank 0 writes and
        every rank waits for it at a barrier."""
        extra = {}
        if self._head_spec is not None:
            extra["heads"] = self.heads
            extra["heads_tag"] = encode_tag(
                f"{self.cfg.heads}|{self.cfg.head_arch}")
            extra["heads_counters"] = np.asarray(
                [self._routed_served, self._overflowed], np.int64)
            if self._heads_perm is not None:
                extra["heads_perm"] = np.asarray(self._heads_perm, np.int64)
        cfg = self.cfg
        if self._enc_spec is not None:
            extra["encoder"] = self.encoder
            extra["encoder_tag"] = encode_tag(_encoder_tag(cfg))
            extra["encoder_counters"] = np.asarray([self._encoded_points],
                                                   np.int64)
        tree = {
            **extra,
            "tau_bufs": self._taubuf.bufs,
            "tau_meta": self._taubuf.meta_array(),
            "server": self.state,
            "counters": self._counters(),
            "policy_id": np.asarray(POLICY_IDS[self.policy.name], np.int64),
            "policy": self.policy.state_arrays(),
            "autoscale_id": np.asarray(AUTOSCALE_IDS[cfg.autoscale],
                                       np.int64),
            "drift_id": np.asarray(DRIFT_IDS[cfg.drift], np.int64),
            "drift_state": np.asarray([self._drift_events,
                                       self._drift_moves,
                                       self._drift_last], np.int64),
            "drift_mass": np.asarray(self._drift_mass, np.float32),
            **self.autoscaler.state_arrays()}
        return save_pytree(path, tree, mesh=self.plane.mesh)

    @classmethod
    def _restore(cls, path: str, cfg: StreamConfig, *,
                 gumbel: Optional[GumbelSource] = None,
                 device="cuda", mesh=None,
                 serve_axes=None) -> "AttachService":
        """A service from an archive of schema v1-v6 (the JAX package's
        or the port's), on ``device``. Serving draws are keyed by the
        archive's base seed unless ``gumbel`` is given; ``mesh`` and
        ``serve_axes`` shard the plane (an archive restores sharded or
        not, whichever way it was written). The policy's slots, a staged
        tau swap (committed at the first flush) with its staged head
        re-map, the autoscale decision state and the drift state are
        taken over, so serving replays the writer's. A pre-v4 archive
        restores under any drift mode with the drift state at its
        defaults; a pre-v6 archive restores under any encoder with a
        fresh encoder drawn from the archive's seed, as a new service
        draws it. An archive is refused by the field it disagrees on:
        ``fold_policy``, ``autoscale`` and ``drift`` where the archive
        was written under another value than ``cfg``'s,
        ``heads``/``head_arch``, and ``encoder``/``encode_dtype``/
        ``encode_seq_len`` where a v6 archive's tag differs (encoder off
        included): the writer's embeddings could not be reproduced."""
        extras = load_extras(path, ("policy_id", "autoscale_id",
                                    "autoscale_state", "autoscale_ladder",
                                    "tau_bufs", "drift_id", "drift_state",
                                    "drift_mass", "server/.epoch",
                                    "heads_tag", "heads_counters",
                                    "heads_perm", "encoder_tag",
                                    "encoder_counters"))
        # Archives from before the policy layer were written under drop.
        saved = (int(extras["policy_id"]) if "policy_id" in extras
                 else POLICY_IDS["drop"])
        if saved != POLICY_IDS[cfg.fold_policy]:
            names = {v: n for n, v in POLICY_IDS.items()}
            raise StreamConfigError(
                f"StreamConfig.fold_policy={cfg.fold_policy!r} does not "
                f"match the checkpoint at {path!r}, which was saved "
                f"under fold_policy={names.get(saved, saved)!r}")
        # v1/v2 archives predate the controller and restore under any
        # autoscale policy with a fresh decision.
        for field_, ids, want in (("autoscale", AUTOSCALE_IDS,
                                   cfg.autoscale),
                                  ("drift", DRIFT_IDS, cfg.drift)):
            if f"{field_}_id" in extras:
                got = int(extras[f"{field_}_id"])
                if got != ids[want]:
                    names = {v: n for n, v in ids.items()}
                    raise StreamConfigError(
                        f"StreamConfig.{field_}={want!r} does not match "
                        f"the checkpoint at {path!r}, which was saved "
                        f"under {field_}={names.get(got, got)!r}")
        if "heads_tag" in extras:
            tag = decode_tag(extras["heads_tag"])
            if tag != f"{cfg.heads}|{cfg.head_arch}":
                sv_h, sv_a = tag.split("|", 1)
                raise StreamConfigError(
                    f"StreamConfig.heads={cfg.heads!r}/"
                    f"head_arch={cfg.head_arch!r} does not match the "
                    f"checkpoint at {path!r}, which was saved under "
                    f"heads={sv_h!r}/head_arch={sv_a!r}")
        if "encoder_tag" in extras:
            tag = decode_tag(extras["encoder_tag"])
            if tag != _encoder_tag(cfg):
                sv_e, sv_dt, sv_sl = tag.split("|", 2)
                raise StreamConfigError(
                    f"StreamConfig.encoder={cfg.encoder!r}/"
                    f"encode_dtype={cfg.encode_dtype!r}/"
                    f"encode_seq_len={cfg.encode_seq_len!r} does not "
                    f"match the checkpoint at {path!r}, which was "
                    f"saved under encoder={sv_e!r}/encode_dtype="
                    f"{sv_dt!r}/encode_seq_len={sv_sl}")
        policy = make_policy(cfg.fold_policy, cfg.capacity,
                             seed=cfg.policy_seed,
                             half_life=cfg.policy_half_life())
        # v1 holds one tau (restored as version 0, both buffers equal);
        # pre-v4 archives hold the fold state without its epoch stamps.
        v2 = "tau_bufs" in extras
        v4srv = "server/.epoch" in extras
        srv_like = server.init_state(cfg.capacity, cfg.k_prime, cfg.d,
                                     device="cpu")
        like = {"server": (srv_like if v4srv
                           else _ServerStateV3(*tuple(srv_like)[:4])),
                "counters": np.zeros((5,), np.int64),
                "policy": policy.state_like()}
        if v2:
            like["tau_bufs"] = torch.zeros((2, cfg.k, cfg.d))
            like["tau_meta"] = np.zeros((3,), np.int64)
        else:
            like["tau"] = torch.zeros((cfg.k, cfg.d))
        if "heads_tag" in extras:
            # The seeded init doubles as the exact-shape template.
            like["heads"] = heads_mod.init_heads(
                torch.Generator(device="cpu").manual_seed(0), cfg.k,
                cfg.head_spec(), device="cpu")
        if "encoder_tag" in extras:
            like["encoder"] = enc_mod.init_encoder(
                torch.Generator(device="cpu").manual_seed(0),
                cfg.encoder_spec(), device="cpu")
        dev = torch.device(device)
        tree = load_pytree(path, like, device=dev)
        policy.load_state(tree["policy"])
        taubuf = (TauBuffer.from_arrays(tree["tau_bufs"], tree["tau_meta"])
                  if v2 else TauBuffer.fresh(tree["tau"]))
        srv = tree["server"]
        if not v4srv:
            srv = server.ServerState(*srv, torch.zeros(
                (cfg.capacity,), dtype=torch.int32, device=dev))
        cnt = np.asarray(tree["counters"])
        svc = cls(cfg, taubuf.tau, tau_buffer=taubuf, state=srv,
                  policy=policy, seed=int(cnt[4]), gumbel=gumbel,
                  next_id=int(cnt[0]), since_refresh=int(cnt[1]),
                  served_devices=int(cnt[2]), served_points=int(cnt[3]),
                  heads=tree.get("heads"), encoder=tree.get("encoder"),
                  device=dev, mesh=mesh, serve_axes=serve_axes)
        if "encoder_counters" in extras:
            svc._encoded_points = int(np.asarray(
                extras["encoder_counters"], np.int64)[0])
        if "heads_counters" in extras:
            hc = np.asarray(extras["heads_counters"], np.int64)
            svc._routed_served, svc._overflowed = int(hc[0]), int(hc[1])
        if "heads_perm" in extras:
            svc._heads_perm = np.asarray(extras["heads_perm"],
                                         np.int64).copy()
        if "drift_state" in extras:
            ds = np.asarray(extras["drift_state"], np.int64)
            svc._drift_events, svc._drift_moves, svc._drift_last = (
                int(ds[0]), int(ds[1]), int(ds[2]))
        if "drift_mass" in extras:
            dm = np.asarray(extras["drift_mass"], np.float32)
            if dm.shape == (cfg.k,):
                svc._drift_mass = dm.copy()
        if "autoscale_state" in extras:
            svc.autoscaler.load_state(extras["autoscale_state"],
                                      extras["autoscale_ladder"])
        return svc

    # ------------------------------------------------------------- stats --

    def _heads_stats(self) -> dict:
        if self._head_spec is None:
            return {"mode": "off"}
        return {
            "mode": self.cfg.heads,
            "arch": self.cfg.head_arch,
            "capacity_factor": float(self.cfg.head_capacity),
            "queue_capacity": route_capacity(
                self.cfg.batch_size, self.cfg.k, self.cfg.head_capacity),
            "params_per_head": heads_mod.head_param_count(self._head_spec),
            "routed_served": self._routed_served,
            "overflowed": self._overflowed,
            "remap_pending": self._heads_perm is not None,
        }

    def _encoder_stats(self) -> dict:
        if self._enc_spec is None:
            return {"mode": "off"}
        return {
            "mode": self.cfg.encoder,
            "dtype": self.cfg.encode_dtype,
            "seq_len": self.cfg.encode_seq_len,
            "layers": self._enc_spec.n_layers,
            "params": enc_mod.encoder_param_count(self._enc_spec),
            "encoded_points": self._encoded_points,
        }

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
            "autoscale": self.autoscaler.stats(),
            "heads": self._heads_stats(),
            "encoder": self._encoder_stats(),
            "drift": {"mode": self.cfg.drift,
                      "half_life": self.cfg.drift_half_life,
                      "events": self._drift_events,
                      "moves": self._drift_moves,
                      "last_moves": self._drift_last,
                      "mass": [float(m) for m in self._drift_mass]},
            **self.plane.describe(),
        }
