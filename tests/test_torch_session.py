"""The slice as a whole: the port's Session (one-shot round, staged
arrival, streaming serve) against the JAX package's Session on the same
numpy data and k-means++ draws. Labels and tau versions exact, tau
within 1e-4 relative to its largest entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import api as japi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.gaussian import (late_device_stream,  # noqa: E402
                                       structured_devices)
from repro_torch.fed.api import FederationPlan, PlanError, Session  # noqa: E402
from repro_torch.utils.metrics import clustering_accuracy  # noqa: E402
from test_torch_prng import JaxRoundGumbel, JaxServeGumbel  # noqa: E402

K, KP, D = 12, 3, 24
SERVE = dict(batch_size=4, bucket_sizes=(32, 64), refresh_every=4)


def _tau_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def mixture():
    return structured_devices(0, k=K, d=D, k_prime=KP, m0=2,
                              n_per_comp_dev=12, sep=30.0)


@pytest.fixture(scope="module")
def jax_round(mixture):
    key = jax.random.PRNGKey(1)
    out = japi.Session(japi.FederationPlan(k=K, k_prime=KP, d=D)).run(
        key, jnp.asarray(mixture.data))
    return key, out


def test_run_matches_jax(mixture, jax_round):
    key, jout = jax_round
    Z = mixture.data.shape[0]
    sess = Session(FederationPlan(k=K, k_prime=KP, d=D, device="cpu"))
    out = sess.run(JaxRoundGumbel(key, Z), mixture.data)
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(jout.labels))
    _tau_close(out.tau_centers.numpy(), jout.tau_centers)
    d, jd = out.detail, jout.detail
    np.testing.assert_array_equal(d.agg.seeds_idx.numpy(),
                                  np.asarray(jd.agg.seeds_idx))
    np.testing.assert_array_equal(d.center_labels.numpy(),
                                  np.asarray(jd.center_labels))
    np.testing.assert_array_equal(d.core_counts.numpy(),
                                  np.asarray(jd.core_counts))
    assert clustering_accuracy(out.labels.numpy(), mixture.labels, K) > 0.95
    assert out.labels.dtype == torch.int32


@pytest.mark.parametrize("weighted", [False, True])
def test_staged_arrival_equals_run_with_participation(mixture, weighted):
    """begin + fold of two cohorts (any order) + finalize == run with
    participation = the union of the cohorts, inside the port."""
    plan = FederationPlan(k=K, k_prime=KP, d=D, device="cpu",
                          weight_by_core_counts=weighted)
    Z = mixture.data.shape[0]
    part = np.isin(np.arange(Z), [0, 2, 3, 5, 6, 7])
    sync = Session(plan).run(5, mixture.data, participation=part)
    staged = (Session(plan).begin(5, mixture.data)
              .fold([6, 2, 7]).fold([0, 5, 3, 2]).finalize())
    torch.testing.assert_close(staged.labels, sync.labels, rtol=0, atol=0)
    torch.testing.assert_close(staged.tau_centers, sync.tau_centers,
                               rtol=0, atol=0)
    assert staged.detail.participated.tolist() == part.tolist()


def _serve_both(mixture, jax_round, serve_dtype, port_round=None):
    key, jout = jax_round
    jplan = japi.FederationPlan(k=K, k_prime=KP, d=D,
                                serve_dtype=serve_dtype, **SERVE)
    jsess = japi.Session.from_round(jplan, jout.detail)
    reqs = late_device_stream(mixture.means, KP, 10, 3, n_range=(10, 60))
    datas = [r[0] for r in reqs]
    kvs = [r[2] for r in reqs]
    want = jsess.serve_versioned(datas, kvs)
    plan = FederationPlan(k=K, k_prime=KP, d=D, serve_dtype=serve_dtype,
                          device="cpu", **SERVE)
    np_round = jax.tree.map(np.asarray, jout.detail)
    rr = (convert.round_result(np_round, device="cpu")
          if port_round is None else port_round)
    sess = Session.from_round(plan, rr, gumbel=JaxServeGumbel(0),
                              device="cpu")
    got = sess.serve_versioned(datas, kvs)
    return got, want, sess, jsess, reqs


@pytest.mark.parametrize("serve_dtype", ["f32", "bf16"])
def test_serve_matches_jax(mixture, jax_round, serve_dtype):
    """From the JAX package's round (carried across by convert), serve 10
    late devices of mixed n over two buckets with a refresh every 4
    folds: every label and tau version equals the JAX Session's."""
    got, want, sess, jsess, reqs = _serve_both(mixture, jax_round,
                                               serve_dtype)
    for i, ((lbl, ver), (jlbl, jver)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(lbl, np.asarray(jlbl),
                                      err_msg=f"request {i}")
        assert ver == jver, (i, ver, jver)
    assert sess.tau_version == jsess.tau_version == 2
    _tau_close(sess.tau_centers.numpy(), jsess.tau_centers)
    st, jst = sess.stats(), jsess.stats()
    for k in ("served_devices", "served_points", "folded", "since_refresh",
              "tau_version"):
        assert st[k] == jst[k], k
    lab = np.concatenate([g[0] for g in got])
    true = np.concatenate([r[1] for r in reqs])
    assert clustering_accuracy(lab, true, K) > 0.95


def test_port_round_serves_like_jax(mixture, jax_round):
    """The port's own round (run with the JAX draws) seeds a service
    whose labels and versions equal the JAX Session's."""
    key, _ = jax_round
    Z = mixture.data.shape[0]
    rr = Session(FederationPlan(k=K, k_prime=KP, d=D, device="cpu")).run(
        JaxRoundGumbel(key, Z), mixture.data).detail
    got, want, _, _, _ = _serve_both(mixture, jax_round, "f32",
                                     port_round=rr)
    for (lbl, ver), (jlbl, jver) in zip(got, want):
        np.testing.assert_array_equal(lbl, np.asarray(jlbl))
        assert ver == jver


def test_submit_flush_and_batching_do_not_change_labels(mixture):
    """A request's labels depend on its own id only: serving requests one
    by one, or queued and flushed together, gives the same labels."""
    plan = FederationPlan(k=K, k_prime=KP, d=D, device="cpu",
                          batch_size=4, bucket_sizes=(32, 64))
    rr = Session(plan).run(0, mixture.data).detail
    reqs = late_device_stream(mixture.means, KP, 6, 4, n_range=(10, 60))
    a = Session.from_round(plan, rr, seed=3)
    rids = [a.submit(r[0], r[2]) for r in reqs]
    batched = a.flush()
    b = Session.from_round(plan, rr, seed=3)
    for rid, r in zip(rids, reqs):
        np.testing.assert_array_equal(b.attach(r[0], r[2]), batched[rid])
    assert a.stats()["served_devices"] == 6


def test_from_tau_and_lifecycle_errors(mixture):
    plan = FederationPlan(k=K, k_prime=KP, d=D, device="cpu")
    sess = Session(plan)
    with pytest.raises(RuntimeError, match="finalized round"):
        sess.serve([np.zeros((4, D), np.float32)])
    with pytest.raises(RuntimeError, match="begin"):
        sess.fold([0])
    with pytest.raises(PlanError, match="feature dim"):
        sess.run(0, np.zeros((2, 5, D + 1), np.float32))
    out = Session(plan).run(0, mixture.data)
    served = Session.from_tau(plan, out.tau_centers.numpy()).attach(
        mixture.data[0])
    assert served.shape == (mixture.data.shape[1],)
    assert clustering_accuracy(served, mixture.labels[0], K) > 0.95


@pytest.mark.parametrize("field,value,extra,match", [
    pytest.param("encoder", "granite_3_2b", {},
                 r"is invalid: accepted values are 'off' or a registered "
                 r"model config \[", id="encoder-granite_3_2b"),
    pytest.param("encoder", "granite-3-2b", {"d": 20},
                 r"is invalid for d=20: the config's n_heads=8 must divide "
                 r"the plan's feature dimension", id="encoder-indivisible")])
def test_plan_refuses_what_is_not_ported(field, value, extra, match):
    """An encoder the port cannot build is refused with the JAX package's
    named error: a name that is not a registered config (the registry
    spells it granite-3-2b), or a config whose attention heads do not
    divide d. It never falls back to something else."""
    with pytest.raises(PlanError, match=f"FederationPlan.{field}=.*" + match):
        FederationPlan(**{**dict(k=K, k_prime=KP, d=D, device="cpu"),
                          field: value, **extra})


@pytest.mark.parametrize("field,value,extra", [
    ("autoscale", "latency", {}), ("autoscale", "throughput", {}),
    ("refresh", "async", {}), ("fold_policy", "lru", {}),
    ("fold_policy", "weighted_reservoir", {}),
    ("serve_axes", ("data",), {"heads": "linear"}),
    ("drift", "decay", {"drift_half_life": 16})])
def test_plan_accepts_the_ported_serving_options(field, value, extra):
    """The serving options this port runs reach the service's config:
    ``serve_axes`` with heads on (the sharded routed step) and drift
    included."""
    plan = FederationPlan(k=K, k_prime=KP, d=D, device="cpu",
                          policy_seed=3, **{field: value, **extra})
    if field == "serve_axes":
        assert plan.serve_axes == value and plan.heads == "linear"
        return
    cfg = plan.stream_config()
    assert getattr(cfg, field) == value and cfg.policy_seed == 3
    for name, v in extra.items():
        assert getattr(cfg, name) == v


@pytest.mark.parametrize("field,value,match", [
    ("autoscale", "fast", "FederationPlan.autoscale='fast' is invalid"),
    ("refresh", "lazy", "FederationPlan.refresh='lazy' is invalid"),
    ("batch_size", 6, "FederationPlan.batch_size=6 is invalid: must be a "
                      "power of two")])
def test_plan_validates_the_serving_options(field, value, match):
    kw = {"autoscale": "latency"} if field == "batch_size" else {}
    with pytest.raises(PlanError, match=match):
        FederationPlan(k=K, k_prime=KP, d=D, device="cpu",
                       **{field: value, **kw})


def test_plan_validation_names_field():
    with pytest.raises(PlanError, match="FederationPlan.k_prime"):
        FederationPlan(k=4, k_prime=5, d=2, device="cpu")
    with pytest.raises(PlanError, match="FederationPlan.serve_dtype"):
        FederationPlan(k=4, k_prime=2, d=2, device="cpu", serve_dtype="f16")
    with pytest.raises(PlanError, match="FederationPlan.device"):
        FederationPlan(k=4, k_prime=2, d=2, device="tpu")
    plan = FederationPlan(k=4, k_prime=2, d=2, device="cpu")
    assert plan.with_options(batch_size=2).batch_size == 2
    assert plan.stream_config().capacity == 1024


def test_from_tau_serves_like_jax(mixture, jax_round):
    """Tau centers carried across by convert.tau serve the JAX Session's
    labels (refresh off: tau stays fixed)."""
    _, jout = jax_round
    jplan = japi.FederationPlan(k=K, k_prime=KP, d=D, batch_size=4,
                                bucket_sizes=(32, 64))
    reqs = late_device_stream(mixture.means, KP, 5, 8, n_range=(10, 60))
    datas, kvs = [r[0] for r in reqs], [r[2] for r in reqs]
    want = japi.Session.from_tau(jplan, jout.tau_centers).serve(datas, kvs)
    plan = FederationPlan(k=K, k_prime=KP, d=D, batch_size=4,
                          bucket_sizes=(32, 64), device="cpu")
    tau = convert.tau(np.asarray(jout.tau_centers), device="cpu")
    got = Session.from_tau(plan, tau, gumbel=JaxServeGumbel(0),
                           device="cpu").serve(datas, kvs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_oversized_request_pads_to_a_doubled_bucket(mixture):
    """A request above the top bucket pads to the next doubling rung,
    warns once per rung, and is still labelled right."""
    import warnings
    from repro_torch.fed.stream import ReproPerfWarning, bucket_of
    assert bucket_of(50, (16, 32)) == 64 and bucket_of(200, (16, 32)) == 256
    assert bucket_of(7, (16, 32)) == 16
    plan = FederationPlan(k=K, k_prime=KP, d=D, device="cpu", batch_size=2,
                          bucket_sizes=(16, 32))
    rr = Session(plan).run(0, mixture.data).detail
    sess = Session.from_round(plan, rr)
    x = late_device_stream(mixture.means, KP, 2, 9, n_range=(50, 60))
    with pytest.warns(ReproPerfWarning, match="exceeds the largest"):
        first = sess.attach(x[0][0], x[0][2])
    with warnings.catch_warnings():
        warnings.simplefilter("error", ReproPerfWarning)
        sess.attach(x[1][0], x[1][2])   # same rung: no second warning
    assert first.shape == (x[0][0].shape[0],)
    assert clustering_accuracy(first, x[0][1], K) > 0.95
