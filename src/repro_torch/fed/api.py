"""The federation API: a declarative ``FederationPlan`` and a ``Session``
lifecycle (counterpart of ``repro/fed/api.py``).

``FederationPlan`` has the JAX package's fields and defaults, plus
``device`` (default ``"cuda"``). The serving options run as in the JAX
package: ``fold_policy`` drop, lru or weighted_reservoir, ``refresh``
sync or async, ``autoscale`` off, latency or throughput, ``drift`` off,
decay or split_merge, ``heads`` off or on. ``topology`` ``replicated``
and ``sharded`` run the round over a ``utils.mesh.Mesh``
(``Session(plan, mesh=...)``, one process per rank) and ``serve_axes``
splits each serve batch, routed or not, over the mesh's ranks. The
encoder, whose code the port does not have yet, is refused with a
``PlanError`` naming the field; that is validation, not a fallback.
``Session`` owns one lifecycle: ``run`` (the one-shot round),
``begin``/``fold``/``finalize``
(asynchronous cohort arrival),
``attach``/``serve``/``submit``/``flush``/``refresh`` (streaming Theorem
3.2 attachment with incremental folding), ``attach_fn`` (a closure that
labels one device against the current tau) and ``save``/``restore``
(checkpoints in the JAX package's schema), and with ``heads`` on,
``serve_predict``/``flush_predict`` (the same serving through
per-cluster heads, DESIGN.md §16).

A Session runs on its device: CUDA unless the caller passes
``device="cpu"``. Without a card it refuses to start rather than run on
the CPU unasked.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Any, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import server
from repro_torch.core.distributed import kfed_shard_map_impl
from repro_torch.core.lloyd import lloyd_attach
from repro_torch.core.local_kmeans import local_prepare, split_local_kw
from repro_torch.fed import engine as E
from repro_torch.fed.plane import ServePlane, ServePlaneError
from repro_torch.fed.stream import AttachService, StreamConfig, StreamConfigError
from repro_torch.utils.prng import GumbelSource

__all__ = ["FederationPlan", "PlanError", "RunResult", "Session",
           "SessionError", "TOPOLOGIES"]

TOPOLOGIES = ("simulated", "replicated", "sharded")
REFRESH_MODES = ("sync", "async")
AUTOSCALE_POLICIES = ("off", "latency", "throughput")
FOLD_POLICIES = ("drop", "lru", "weighted_reservoir")
DRIFT_MODES = ("off", "decay", "split_merge")
ENCODE_DTYPES = ("f32", "bf16")


class PlanError(ValueError):
    """A FederationPlan field failed validation; the message names the
    field and the accepted values."""


class SessionError(RuntimeError):
    """A Session method was called out of lifecycle order."""


def _bad(fieldname: str, got: Any, accepted: str) -> None:
    raise PlanError(
        f"FederationPlan.{fieldname}={got!r} is invalid: {accepted}")


def _not_ported(fieldname: str, got: Any, has: str) -> None:
    raise PlanError(
        f"FederationPlan.{fieldname}={got!r} is not in the PyTorch port "
        f"yet: it has {has}")


def resolve_device(device) -> torch.device:
    """The device a session runs on. CUDA must be there when asked for:
    the port never moves to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this Session runs on CUDA, but torch.cuda.is_available() is "
            "False: run it on a machine with an NVIDIA GPU, or pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


@dataclass(frozen=True)
class FederationPlan:
    """Declarative spec of a federated clustering deployment: ``k``
    global clusters, ``k_prime`` per-device center cap, ``d`` feature
    dimension, and the execution, fold and streaming options of the JAX
    package's plan (see ``repro/fed/api.py``). ``device`` is where the
    session runs (``"cuda"`` or ``"cpu"``)."""
    k: int
    k_prime: int
    d: int
    topology: str = "simulated"
    mesh_axes: Tuple[str, ...] = ("data",)
    weight_by_core_counts: bool = False
    local_kw: Mapping[str, Any] = field(default_factory=dict)
    fold_capacity: Optional[int] = None
    capacity: int = 1024
    batch_size: int = 8
    bucket_sizes: Tuple[int, ...] = (64, 256, 1024)
    refresh_every: int = 0
    refresh: str = "sync"
    autoscale: str = "off"
    serve_axes: Optional[Tuple[str, ...]] = None
    fold_reports: bool = True
    fold_policy: str = "drop"
    policy_seed: int = 0
    serve_dtype: str = "f32"
    drift: str = "off"
    drift_half_life: int = 0
    drift_split_factor: float = 2.0
    drift_retire_frac: float = 0.1
    drift_max_moves: int = 1
    heads: str = "off"
    head_capacity: float = 1.25
    head_arch: str = "ffn"
    encoder: str = "off"
    encode_dtype: str = "f32"
    encode_seq_len: int = 64
    checkpoint: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            _bad("topology", self.topology,
                 f"accepted values are {list(TOPOLOGIES)}")
        if isinstance(self.mesh_axes, str):
            object.__setattr__(self, "mesh_axes", (self.mesh_axes,))
        if (not self.mesh_axes
                or not all(isinstance(a, str) for a in self.mesh_axes)):
            _bad("mesh_axes", self.mesh_axes,
                 "must be a non-empty tuple of mesh axis names")
        if self.fold_capacity is not None and self.fold_capacity < 1:
            _bad("fold_capacity", self.fold_capacity,
                 "must be None (infer the device count) or an int >= 1")
        if isinstance(self.serve_axes, str):
            object.__setattr__(self, "serve_axes", (self.serve_axes,))
        if self.serve_axes is not None:
            if (not self.serve_axes
                    or not all(isinstance(a, str) for a in self.serve_axes)):
                _bad("serve_axes", self.serve_axes,
                     "must be None (single-device serving) or a non-empty "
                     "tuple of mesh axis names, e.g. ('data',)")
            object.__setattr__(self, "serve_axes", tuple(self.serve_axes))
        if not isinstance(self.local_kw, Mapping):
            _bad("local_kw", self.local_kw,
                 "must be a mapping of Algorithm 1 options")
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError):
            dev = None
        if dev is None or dev.type not in ("cuda", "cpu"):
            _bad("device", self.device, "accepted values are 'cuda' (or "
                 "'cuda:<index>') and 'cpu'")
        self._check_not_ported()
        try:
            self.stream_config()
        except StreamConfigError as e:
            raise PlanError(str(e).replace("StreamConfig.",
                                           "FederationPlan.")) from None

    def _check_not_ported(self) -> None:
        """The JAX package's values of the serving options, with the one
        whose code the port does not have yet (the encoder) refused by
        name."""
        for name, accepted in (("refresh", REFRESH_MODES),
                               ("autoscale", AUTOSCALE_POLICIES),
                               ("fold_policy", FOLD_POLICIES),
                               ("drift", DRIFT_MODES)):
            got = getattr(self, name)
            if got not in accepted:
                _bad(name, got, f"accepted values are {list(accepted)}")
        if not isinstance(self.policy_seed, int) or self.policy_seed < 0:
            _bad("policy_seed", self.policy_seed,
                 "must be a non-negative int")
        if self.encode_dtype not in ENCODE_DTYPES:
            _bad("encode_dtype", self.encode_dtype,
                 f"accepted values are {list(ENCODE_DTYPES)}")
        if self.encoder != "off":
            _not_ported("encoder", self.encoder, "'off'")

    def engine_config(self) -> E.EngineConfig:
        return E.EngineConfig(
            k=self.k, k_prime=self.k_prime,
            weight_by_core_counts=self.weight_by_core_counts,
            local_kw=dict(self.local_kw))

    def stream_config(self) -> StreamConfig:
        return StreamConfig(
            k=self.k, k_prime=self.k_prime, d=self.d,
            capacity=self.capacity, batch_size=self.batch_size,
            bucket_sizes=tuple(self.bucket_sizes),
            refresh_every=self.refresh_every, refresh=self.refresh,
            autoscale=self.autoscale, fold_reports=self.fold_reports,
            weight_by_core_counts=self.weight_by_core_counts,
            fold_policy=self.fold_policy, policy_seed=self.policy_seed,
            serve_dtype=self.serve_dtype, drift=self.drift,
            drift_half_life=self.drift_half_life,
            drift_split_factor=self.drift_split_factor,
            drift_retire_frac=self.drift_retire_frac,
            drift_max_moves=self.drift_max_moves, heads=self.heads,
            head_capacity=self.head_capacity,
            head_arch=self.head_arch, local_kw=dict(self.local_kw))

    def with_options(self, **kw) -> "FederationPlan":
        """A copy of the plan with fields replaced (re-validated)."""
        return replace(self, **kw)


class RunResult(NamedTuple):
    """What ``Session.run`` and ``Session.finalize`` return."""
    labels: torch.Tensor            # (Z, n) induced clustering, -1 padded
    tau_centers: torch.Tensor       # (k, d)
    detail: Optional[E.RoundResult] = None


class Session:
    """One federation lifecycle against one ``FederationPlan``::

        plan = FederationPlan(k=16, k_prime=4, d=24)
        sess = Session(plan)                     # on the card
        out = sess.run(0, device_data)           # the one-shot round
        labels = sess.attach(late_device_data)   # Theorem 3.2 serving

    ``run``'s first argument keys the round's k-means++ draws: an int
    seed, or a ``utils.prng.GumbelSource``. ``seed`` (or ``gumbel``)
    keys the serving requests' draws by request id. ``device`` overrides
    the plan's device. With ``plan.heads`` on, ``heads`` are the
    per-cluster head parameters the serving layer starts with (see
    ``convert.heads`` for the JAX package's); by default they are drawn
    from ``seed``.

    The ``replicated`` and ``sharded`` topologies and ``serve_axes``
    take ``mesh``, a ``utils.mesh.Mesh``: every rank builds the same
    Session and calls it with the same host inputs, moves only its
    shard to its device, and gets the same results back (the round's
    labels gathered, tau replicated). A checkpoint is written by rank 0.
    """

    def __init__(self, plan: FederationPlan, *, mesh=None, seed: int = 0,
                 device=None, gumbel: Optional[GumbelSource] = None,
                 heads=None):
        if not isinstance(plan, FederationPlan):
            raise PlanError(f"Session needs a FederationPlan, got "
                            f"{type(plan).__name__}")
        if plan.topology != "simulated":
            if mesh is None:
                raise PlanError(
                    f"FederationPlan.topology={plan.topology!r} needs a "
                    f"mesh: Session(plan, mesh=...)")
            missing = [a for a in plan.mesh_axes if a not in mesh.shape]
            if missing:
                _bad("mesh_axes", tuple(plan.mesh_axes),
                     f"axes {missing} not in the mesh (available: "
                     f"{list(mesh.shape)})")
        if plan.serve_axes is not None:
            # The serve plane's one rule set, checked now rather than at
            # the first (lazy) serve.
            try:
                ServePlane.validate_mesh_axes(mesh, plan.serve_axes,
                                              plan.batch_size)
            except ServePlaneError as e:
                raise PlanError(str(e)) from None
        self.plan = plan
        self.mesh = mesh
        self.device = resolve_device(plan.device if device is None
                                     else device)
        self._seed = int(seed)
        self._gumbel = gumbel
        self._heads = heads
        self._round: Optional[E.RoundResult] = None
        self._tau: Optional[torch.Tensor] = None
        self._svc: Optional[AttachService] = None
        self._loc = None
        self._fold_w = None
        self._fold_state = None
        self._fold_part = None
        self._fold_cap = None

    # ------------------------------------------------------ one-shot --
    def run(self, key, data, *, participation=None, k_valid=None,
            point_mask=None) -> RunResult:
        """The one communication round (Algorithm 1 on every device,
        Algorithm 2 on the server, Definition 3.3 labels)."""
        if self.plan.topology == "simulated":
            data = self._data(data)
            rr = E.run_round_impl(self._source(key), data,
                                  self.plan.engine_config(),
                                  participation=self._tensor(participation),
                                  k_valid=self._tensor(k_valid),
                                  point_mask=self._tensor(point_mask))
            self._set_round(rr, rr.agg.tau_centers)
            return RunResult(rr.labels, rr.agg.tau_centers, rr)
        # Every rank holds the host inputs and moves its own shard.
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data, np.float32)
        self._check_data(data)
        labels, tau = kfed_shard_map_impl(
            self.mesh, data, self.plan.k, self.plan.k_prime,
            source=self._source(key), axis=tuple(self.plan.mesh_axes),
            server=self.plan.topology, participation=participation,
            weight_by_core_counts=self.plan.weight_by_core_counts,
            k_valid=k_valid, point_mask=point_mask, device=self.device,
            **dict(self.plan.local_kw))
        self._set_round(None, tau)
        return RunResult(labels, tau, None)

    # ---------------------------------------------------- async fold --
    def begin(self, key, data, *, k_valid=None,
              point_mask=None) -> "Session":
        """Start an asynchronous round: run the local stage (Algorithm 1
        on every device) and open an empty fold state sized
        ``plan.fold_capacity`` (default: the device count). Staged
        arrival runs on the simulated topology."""
        if self.plan.topology != "simulated":
            raise SessionError(
                "fold/finalize staged arrival runs on the simulated "
                "topology; the replicated and sharded topologies are "
                "one-shot run()")
        data = self._data(data)
        cfg = self.plan.engine_config()
        loc = E.local_stage(self._source(key), data, cfg,
                            k_valid=self._tensor(k_valid),
                            point_mask=self._tensor(point_mask))
        Z = data.shape[0]
        cap = self.plan.fold_capacity or Z
        self._loc = loc
        self._fold_w = (E.core_weights(loc)
                        if self.plan.weight_by_core_counts else None)
        self._fold_state = server.init_state(
            cap, self.plan.k_prime, data.shape[-1], loc.centers.dtype,
            device=self.device)
        self._fold_part = torch.zeros((Z,), dtype=torch.bool,
                                      device=self.device)
        self._fold_cap = cap
        return self

    def fold(self, cohort, *, key=None, data=None, k_valid=None,
             point_mask=None) -> "Session":
        """Fold one cohort's reports into the staged-arrival state, in any
        order, across any number of calls; re-delivery is idempotent. The
        first call may carry ``key``/``data`` instead of :meth:`begin`."""
        if self._loc is None:
            if key is None or data is None:
                raise SessionError(
                    "first fold() needs key= and data= (or call "
                    "begin(key, data) first)")
            self.begin(key, data, k_valid=k_valid, point_mask=point_mask)
        ids = np.asarray(cohort, np.int64).reshape(-1)
        Z = int(self._fold_part.shape[0])
        if ids.size and (ids.min() < 0 or ids.max() >= Z):
            bad = ids[(ids < 0) | (ids >= Z)]
            raise SessionError(
                f"fold() cohort contains device ids {bad.tolist()} "
                f"outside [0, Z={Z})")
        # Ids past fold_capacity are in the round but not in the state.
        in_cap = torch.from_numpy(ids[ids < self._fold_cap]).to(self.device)
        w = self._fold_w
        self._fold_state = server.aggregate_incremental(
            self._fold_state, in_cap, self._loc.centers[in_cap],
            self._loc.center_mask[in_cap],
            weights=None if w is None else w[in_cap])
        self._fold_part[in_cap] = True
        return self

    def finalize(self) -> RunResult:
        """Close the staged round: Algorithm 2 over every folded report,
        Theorem 3.2 attachment of devices that never reported. Equal to
        ``run`` with ``participation`` = the union of the cohorts."""
        if self._loc is None:
            raise SessionError("finalize() before any fold()/begin()")
        agg = server.finalize(self._fold_state, self.plan.k,
                              weighted=self.plan.weight_by_core_counts)
        center_labels = server.attach_absent_devices(
            agg.center_labels, self._loc.centers, self._loc.center_mask,
            agg.tau_centers, self._fold_part)
        rr = E._finish(self._loc, agg, center_labels, self._fold_part)
        self._set_round(rr, rr.agg.tau_centers)
        return RunResult(rr.labels, rr.agg.tau_centers, rr)

    # ----------------------------------------------------- streaming --
    @property
    def service(self) -> AttachService:
        """The streaming attachment layer, started on first use: seeded
        with tau and the participants' reports after a simulated round,
        or with tau alone after a replicated or sharded round (the
        device reports never left their shards) or :meth:`from_tau`."""
        if self._svc is None:
            cfg = self.plan.stream_config()
            kw = dict(seed=self._seed, gumbel=self._gumbel,
                      heads=self._heads, device=self.device, mesh=self.mesh,
                      serve_axes=self.plan.serve_axes)
            if self._round is not None:
                self._svc = AttachService._from_round(self._round, cfg, **kw)
            elif self._tau is not None:
                if self.plan.refresh_every:
                    warnings.warn(
                        "Session streaming is seeded with tau centers only "
                        "(a replicated or sharded round, or from_tau): "
                        "refresh_every will re-finalize over the streamed "
                        "reports alone, without the round's device "
                        "reports. Seed via a simulated round or "
                        "Session.from_round, or set refresh_every=0 to "
                        "keep tau fixed.", UserWarning, stacklevel=3)
                self._svc = AttachService(cfg, self._tau, **kw)
            else:
                raise SessionError(
                    "streaming needs a finalized round: call run() or "
                    "fold()+finalize() first (or Session.from_round / "
                    "Session.from_tau)")
        return self._svc

    @property
    def tau_centers(self) -> torch.Tensor:
        """The current retained centers (tracks streaming refreshes)."""
        if self._svc is not None:
            return self._svc.tau
        if self._tau is None:
            raise SessionError("no finalized round yet")
        return self._tau

    def attach(self, data, k_valid: Optional[int] = None) -> np.ndarray:
        """Serve ONE late-joining device (Theorem 3.2); returns its (n,)
        point labels."""
        return self.serve([data],
                          None if k_valid is None else [k_valid])[0]

    def serve(self, datas, k_valid=None) -> List[np.ndarray]:
        """Serve a batch of late devices; their reports fold by the
        plan's admission policy."""
        return self.service.serve(datas, k_valid)

    def serve_versioned(self, datas, k_valid=None):
        """Like :meth:`serve`, returning (labels, tau_version) pairs."""
        return self.service.serve_versioned(datas, k_valid)

    def serve_predict(self, datas, k_valid=None):
        """Serve a batch through the plan's per-cluster heads
        (``plan.heads != "off"``): one ``stream.ServedPrediction`` per
        input, the :meth:`serve_versioned` labels and version plus the
        routed head's pooled prediction, the majority-vote cluster, and
        whether the request was routed (or overflowed its queue)."""
        return self.service.serve_predict(datas, k_valid)

    def submit(self, data, k_valid: Optional[int] = None) -> int:
        return self.service.submit(data, k_valid)

    def flush(self):
        return self.service.flush()

    def flush_versioned(self):
        """{request_id: (labels, tau_version)} for every pending request."""
        return self.service.flush_versioned()

    def flush_predict(self):
        """{request_id: ``stream.ServedPrediction``} for every pending
        request (``plan.heads != "off"``)."""
        return self.service.flush_predict()

    def refresh(self):
        """Re-finalize Algorithm 2 over all folded reports and swap in
        fresh tau centers now (one atomic version bump)."""
        return self.service.refresh()

    @property
    def tau_version(self) -> int:
        return self.service.tau_version

    def stats(self) -> dict:
        """Live serving counters, the autoscale controller's decision and
        last flush telemetry (``"autoscale"``), and ``"plane_compiles"``,
        the serve plane's distinct step shapes (flat in steady state)."""
        return self.service.stats()

    def attach_fn(self):
        """A ``(key, device_data) -> point labels`` closure over the
        current tau centers: Algorithm 1 steps 1-3 on the device's
        (n, d) points, then one fused ``lloyd_attach`` (one
        ``solve_attach`` launch on the card) under ``plan.serve_dtype``,
        on the session's device. ``key`` is an int seed or a
        ``utils.prng.GumbelSource``; the k-means++ draws are those of
        its id 0."""
        tau = self.tau_centers
        kp = self.plan.k_prime
        prep_kw, max_iters = split_local_kw(dict(self.plan.local_kw))
        serve_dtype = self.plan.serve_dtype

        def attach(key, device_data) -> torch.Tensor:
            x = self._tensor(device_data).float()[None]
            gumbel = self._source(key).draw([0], kp, x.shape[1], x.device)
            prep = local_prepare(gumbel, x, k_max=kp, **prep_kw)
            labels, _, _, _ = lloyd_attach(
                x, prep.theta, tau, center_mask=prep.center_mask,
                max_iters=max_iters, serve_dtype=serve_dtype)
            return labels[0]

        return attach

    # ---------------------------------------------------- checkpoint --
    def save(self, path: Optional[str] = None) -> str:
        """Checkpoint the serving state (tau buffers and version, fold
        state, counters, policy state, heads) in the JAX package's npz
        schema; ``path`` defaults to ``plan.checkpoint``. Returns the
        file's name."""
        path = path or self.plan.checkpoint
        if not path:
            raise SessionError(
                "save() needs a path (or set FederationPlan.checkpoint)")
        return self.service.save(path)

    @classmethod
    def restore(cls, path: str, plan: FederationPlan, *, mesh=None,
                seed: int = 0, device=None,
                gumbel: Optional[GumbelSource] = None) -> "Session":
        """A serving session from a checkpoint written by :meth:`save` or
        by the JAX package's ``Session.save`` (schemas v1-v5), on
        ``device`` (default: ``plan.device``); every rank of ``mesh``
        restores. Restore then serve gives the labels and tau versions
        of the uninterrupted session, sharded or not: the serving draws
        are keyed by the archive's base seed, or come from ``gumbel``."""
        sess = cls(plan, mesh=mesh, seed=seed, device=device, gumbel=gumbel)
        sess._svc = AttachService._restore(path, plan.stream_config(),
                                           gumbel=gumbel,
                                           device=sess.device, mesh=mesh,
                                           serve_axes=plan.serve_axes)
        sess._tau = sess._svc.tau
        return sess

    @classmethod
    def from_round(cls, plan: FederationPlan, round_result: E.RoundResult,
                   **kw) -> "Session":
        """A session whose serving layer is seeded from a finished round
        (tau centers + participants' fold reports); see ``convert`` for a
        round computed by the JAX package."""
        sess = cls(plan, **kw)
        sess._round = round_result
        sess._tau = round_result.agg.tau_centers
        return sess

    @classmethod
    def from_tau(cls, plan: FederationPlan, tau_centers, **kw) -> "Session":
        """A serving-only session seeded with retained tau centers."""
        sess = cls(plan, **kw)
        sess._tau = sess._tensor(tau_centers).float()
        return sess

    # ------------------------------------------------------- helpers --
    def _source(self, key) -> GumbelSource:
        return key if isinstance(key, GumbelSource) else GumbelSource(key)

    def _tensor(self, x):
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=self.device)

    def _set_round(self, rr, tau) -> None:
        """Adopt a newly finalized round; a serving layer built from an
        earlier round is dropped so serving never uses stale tau."""
        self._round, self._tau = rr, tau
        self._svc = None

    def _check_data(self, data) -> None:
        shape = tuple(data.shape if hasattr(data, "shape")
                      else np.shape(data))
        if len(shape) != 3:
            raise PlanError(f"device data must be (Z, n, d), got shape "
                            f"{shape}")
        if int(shape[-1]) != self.plan.d:
            raise PlanError(f"device data feature dim {int(shape[-1])}"
                            f" != FederationPlan.d={self.plan.d}")

    def _data(self, data) -> torch.Tensor:
        data = self._tensor(data).float()
        self._check_data(data)
        return data
