"""The federation API: a declarative ``FederationPlan`` and a ``Session``
lifecycle (counterpart of ``repro/fed/api.py``).

``FederationPlan`` has the JAX package's fields and defaults, plus
``device`` (default ``"cuda"``). A value whose code the port does not
have yet is refused with a ``PlanError`` naming the field; that is
validation, not a fallback. ``Session`` owns one lifecycle: ``run`` (the
one-shot round), ``begin``/``fold``/``finalize`` (asynchronous cohort
arrival) and ``attach``/``serve``/``submit``/``flush``/``refresh``
(streaming Theorem 3.2 attachment with incremental folding).

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
from repro_torch.fed import engine as E
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
        if self.topology != "simulated":
            _not_ported("topology", self.topology, "'simulated'")
        if isinstance(self.mesh_axes, str):
            object.__setattr__(self, "mesh_axes", (self.mesh_axes,))
        if (not self.mesh_axes
                or not all(isinstance(a, str) for a in self.mesh_axes)):
            _bad("mesh_axes", self.mesh_axes,
                 "must be a non-empty tuple of mesh axis names")
        if self.fold_capacity is not None and self.fold_capacity < 1:
            _bad("fold_capacity", self.fold_capacity,
                 "must be None (infer the device count) or an int >= 1")
        if self.serve_axes is not None:
            _not_ported("serve_axes", self.serve_axes,
                        "None (single-device serving)")
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
        """The JAX package's values of the serving options, with the ones
        whose code the port does not have yet refused by name."""
        choices = (("refresh", REFRESH_MODES, "sync"),
                   ("autoscale", AUTOSCALE_POLICIES, "off"),
                   ("fold_policy", FOLD_POLICIES, "drop"),
                   ("drift", DRIFT_MODES, "off"))
        for name, accepted, ported in choices:
            got = getattr(self, name)
            if got not in accepted:
                _bad(name, got, f"accepted values are {list(accepted)}")
            if got != ported:
                _not_ported(name, got, repr(ported))
        if not isinstance(self.policy_seed, int) or self.policy_seed < 0:
            _bad("policy_seed", self.policy_seed,
                 "must be a non-negative int")
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
        if not (isinstance(self.head_capacity, (int, float))
                and float(self.head_capacity) > 0.0):
            _bad("head_capacity", self.head_capacity, "must be a float > 0")
        if self.heads != "off":
            _not_ported("heads", self.heads, "'off'")
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
            refresh_every=self.refresh_every,
            fold_reports=self.fold_reports,
            weight_by_core_counts=self.weight_by_core_counts,
            fold_policy=self.fold_policy, serve_dtype=self.serve_dtype,
            local_kw=dict(self.local_kw))

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
    the plan's device.
    """

    def __init__(self, plan: FederationPlan, *, seed: int = 0,
                 device=None, gumbel: Optional[GumbelSource] = None):
        if not isinstance(plan, FederationPlan):
            raise PlanError(f"Session needs a FederationPlan, got "
                            f"{type(plan).__name__}")
        self.plan = plan
        self.device = resolve_device(plan.device if device is None
                                     else device)
        self._seed = int(seed)
        self._gumbel = gumbel
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
        data = self._data(data)
        rr = E.run_round_impl(self._source(key), data,
                              self.plan.engine_config(),
                              participation=self._tensor(participation),
                              k_valid=self._tensor(k_valid),
                              point_mask=self._tensor(point_mask))
        self._set_round(rr, rr.agg.tau_centers)
        return RunResult(rr.labels, rr.agg.tau_centers, rr)

    # ---------------------------------------------------- async fold --
    def begin(self, key, data, *, k_valid=None,
              point_mask=None) -> "Session":
        """Start an asynchronous round: run the local stage (Algorithm 1
        on every device) and open an empty fold state sized
        ``plan.fold_capacity`` (default: the device count)."""
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
        with tau and the participants' reports after a round, or with tau
        alone after :meth:`from_tau`."""
        if self._svc is None:
            cfg = self.plan.stream_config()
            kw = dict(seed=self._seed, gumbel=self._gumbel,
                      device=self.device)
            if self._round is not None:
                self._svc = AttachService._from_round(self._round, cfg, **kw)
            elif self._tau is not None:
                if self.plan.refresh_every:
                    warnings.warn(
                        "Session streaming is seeded with tau centers only "
                        "(from_tau): refresh_every will re-finalize over "
                        "the streamed reports alone, without the round's "
                        "device reports. Seed via a round or "
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

    def submit(self, data, k_valid: Optional[int] = None) -> int:
        return self.service.submit(data, k_valid)

    def flush(self):
        return self.service.flush()

    def flush_versioned(self):
        """{request_id: (labels, tau_version)} for every pending request."""
        return self.service.flush_versioned()

    def refresh(self):
        """Re-finalize Algorithm 2 over all folded reports and swap in
        fresh tau centers now (one atomic version bump)."""
        return self.service.refresh()

    @property
    def tau_version(self) -> int:
        return self.service.tau_version

    def stats(self) -> dict:
        return self.service.stats()

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

    def _data(self, data) -> torch.Tensor:
        data = self._tensor(data).float()
        if data.dim() != 3:
            raise PlanError(f"device data must be (Z, n, d), got shape "
                            f"{tuple(data.shape)}")
        if int(data.shape[-1]) != self.plan.d:
            raise PlanError(f"device data feature dim {int(data.shape[-1])}"
                            f" != FederationPlan.d={self.plan.d}")
        return data
