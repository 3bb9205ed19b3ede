"""The routed personalization serving path of the port (fed/plane.py
routed step, fed/stream.py and fed/api.py serve_predict/flush_predict)
against the JAX package's, on the same numpy data, tau, head parameters
(convert.heads) and k-means++ draws (the JAX package's own keys,
test_torch_prng.JaxServeGumbel).

Exact: labels, center masks, votes (``cluster``), the keep mask
(``kept``/``routed``) and tau versions. Centers, weights and tau within
1e-4 of their largest entry (as test_torch_session.py). Predictions in
f32 within 1e-5 * max|y|, with bf16 storage within 2e-2 * max(max|y|, 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import api as japi  # noqa: E402
from repro.fed import plane as jplane  # noqa: E402
from repro.fed.stream import StreamConfig as JaxStreamConfig  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.gaussian import (late_device_stream,  # noqa: E402
                                       structured_devices)
from repro_torch.fed import plane  # noqa: E402
from repro_torch.fed.api import FederationPlan, PlanError, Session  # noqa: E402
from repro_torch.fed.stream import StreamConfig, StreamConfigError  # noqa: E402
from test_torch_prng import JaxServeGumbel  # noqa: E402


def _close(got, want, scale=1e-4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(float(np.abs(want).max()),
                                                1e-30))


def _preds_close(got, want, serve_dtype):
    want = np.asarray(want)
    peak = float(np.abs(want).max())
    atol = 1e-5 * peak if serve_dtype == "f32" else 2e-2 * max(peak, 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol)


# ------------------------------------------------------------ the step --

STEP_CASES = [
    # case, k, heads, head_arch, serve_dtype, head_capacity
    ("spread", 8, "qwen1.5-0.5b", "ffn", "f32", 1.25),
    ("one_cluster", 4, "linear", "ffn", "f32", 1.0),
    ("repeat_pad", 8, "granite-3-2b", "transformer", "f32", 1.25),
    ("spread", 8, "whisper-base", "transformer", "bf16", 1.25),
]


def _step_inputs(case, k, B=8, n=32, d=16, kp=2):
    """(tau, data, pmask, k_valid, request ids) for one batch."""
    rng = np.random.default_rng(k + B)
    tau = (rng.normal(size=(k, d)) * 20).astype(np.float32)
    owner = (np.arange(B) % k if case != "one_cluster"
             else np.zeros(B, np.int64))
    data = (rng.normal(size=(B, n, d)) + tau[owner][:, None]).astype(
        np.float32)
    pmask = np.ones((B, n), bool)
    pmask[1, 20:] = False
    kv = np.full((B,), kp, np.int32)
    kv[2] = 1
    rids = np.arange(100, 100 + B)
    if case == "repeat_pad":
        # The service pads a short batch by repeating its last request.
        for i in range(5, B):
            data[i], pmask[i], kv[i], rids[i] = (data[4], pmask[4], kv[4],
                                                 rids[4])
    return tau, data, pmask, kv, rids


@pytest.mark.parametrize("case,k,heads,arch,serve_dtype,cap", STEP_CASES)
def test_routed_step_matches_jax(case, k, heads, arch, serve_dtype, cap):
    kw = dict(k=k, k_prime=2, d=16, capacity=64, batch_size=8,
              bucket_sizes=(32,), heads=heads, head_arch=arch,
              serve_dtype=serve_dtype, head_capacity=cap)
    jcfg, cfg = JaxStreamConfig(**kw), StreamConfig(**kw)
    tau, data, pmask, kv, rids = _step_inputs(case, k)
    jp = jheads.init_heads(jax.random.PRNGKey(3), k, jcfg.head_spec())
    base = jax.random.PRNGKey(0)
    keys = jax.vmap(lambda r: jax.random.fold_in(base, r))(
        jnp.asarray(rids, jnp.uint32))
    want = jax.jit(jplane._make_routed_step(jcfg))(
        jnp.asarray(tau), jp, keys, jnp.asarray(data), jnp.asarray(pmask),
        jnp.asarray(kv))
    want = [np.asarray(w) for w in want]
    gumbel = JaxServeGumbel(0).draw(rids.tolist(), 2, 32, "cpu")
    got = plane._make_routed_step(cfg)(
        torch.as_tensor(tau), convert.heads(jax.tree.map(np.asarray, jp),
                                            device="cpu"),
        gumbel, torch.as_tensor(data), torch.as_tensor(pmask),
        torch.as_tensor(kv))
    got = [g.numpy() for g in got]
    labels, centers, cmask, weights, preds, cluster, kept = got
    np.testing.assert_array_equal(labels, want[0])
    np.testing.assert_array_equal(cmask, want[2])
    _close(centers, want[1])
    _close(weights, want[3])
    np.testing.assert_array_equal(cluster, want[5])
    np.testing.assert_array_equal(kept, want[6])
    assert cluster.dtype == np.int32 and kept.dtype == bool
    _preds_close(preds, want[4], serve_dtype)
    assert np.all(preds[~kept] == 0.0)
    C = plane.route_capacity(8, k, cap)
    assert C == jplane.route_capacity(8, k, cap)
    if case == "one_cluster":
        np.testing.assert_array_equal(kept, np.arange(8) < C)
    if case == "repeat_pad":
        # Repeat-padding rows vote and take queue slots like any row.
        assert (cluster[4:] == cluster[4]).all() and kept[5:].any()


def test_routed_step_labels_equal_plain_step():
    """The routed step shares the label body: labels, centers, masks and
    weights equal the heads-off step's bit for bit."""
    cfg = StreamConfig(k=8, k_prime=2, d=16, capacity=64, batch_size=8,
                       bucket_sizes=(32,), heads="nemotron-4-15b")
    tau, data, pmask, kv, rids = _step_inputs("spread", 8)
    args = (torch.as_tensor(tau), None, torch.as_tensor(data),
            torch.as_tensor(pmask), torch.as_tensor(kv))
    from repro_torch.models.heads import init_heads
    p = init_heads(torch.Generator().manual_seed(0), 8, cfg.head_spec(),
                   device="cpu")
    g = JaxServeGumbel(0).draw(rids.tolist(), 2, 32, "cpu")
    plain = plane._make_step(cfg)(args[0], g, *args[2:])
    routed = plane._make_routed_step(cfg)(args[0], p, g, *args[2:])
    for a, b in zip(plain, routed[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ Session --

K, KP, D = 12, 3, 24
SERVE = dict(batch_size=4, bucket_sizes=(32, 64), refresh_every=4)


@pytest.fixture(scope="module")
def mixture():
    return structured_devices(0, k=K, d=D, k_prime=KP, m0=2,
                              n_per_comp_dev=12, sep=30.0)


@pytest.fixture(scope="module")
def jax_round(mixture):
    return japi.Session(japi.FederationPlan(k=K, k_prime=KP, d=D)).run(
        jax.random.PRNGKey(1), jnp.asarray(mixture.data)).detail


def _port_round(jax_round):
    return convert.round_result(jax.tree.map(np.asarray, jax_round),
                                device="cpu")


def _sessions(jax_round, heads, arch, serve_dtype="f32"):
    """The JAX Session and the port's, from the same round and heads."""
    opts = dict(k=K, k_prime=KP, d=D, heads=heads, head_arch=arch,
                serve_dtype=serve_dtype, **SERVE)
    jsess = japi.Session.from_round(japi.FederationPlan(**opts), jax_round)
    np_heads = jax.tree.map(np.asarray, jsess.service.heads)
    sess = Session.from_round(
        FederationPlan(device="cpu", **opts), _port_round(jax_round),
        heads=convert.heads(np_heads, device="cpu"),
        gumbel=JaxServeGumbel(0), device="cpu")
    return jsess, sess


def _assert_served_equal(got, want, serve_dtype):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.labels, np.asarray(w.labels),
                                      err_msg=f"request {i}")
        assert (g.tau_version, g.cluster, g.routed) == (
            w.tau_version, w.cluster, w.routed), i
        assert g.prediction.shape == (D,) and g.prediction.dtype == np.float32
        if not g.routed:
            assert np.all(g.prediction == 0.0)
    _preds_close(np.stack([g.prediction for g in got]),
                 np.stack([np.asarray(w.prediction) for w in want]),
                 serve_dtype)


@pytest.mark.parametrize("heads,arch,serve_dtype", [
    ("qwen1.5-0.5b", "transformer", "f32"), ("linear", "ffn", "bf16")])
def test_session_serve_predict_matches_jax(mixture, jax_round, heads, arch,
                                           serve_dtype):
    """serve_predict over two buckets with a refresh every 4 folds, then
    submit + flush_predict: labels, versions, votes and routing exact,
    predictions within tolerance, the same heads counters."""
    jsess, sess = _sessions(jax_round, heads, arch, serve_dtype)
    reqs = late_device_stream(mixture.means, KP, 10, 3, n_range=(10, 60))
    datas, kvs = [r[0] for r in reqs], [r[2] for r in reqs]
    got = sess.serve_predict(datas, kvs)
    want = jsess.serve_predict(datas, kvs)
    _assert_served_equal(got, want, serve_dtype)
    assert not all(g.routed for g in got)      # C = 1 at batch 4, k = 12
    more = late_device_stream(mixture.means, KP, 5, 4, n_range=(10, 60))
    rids = [sess.submit(r[0], r[2]) for r in more]
    jrids = [jsess.submit(r[0], r[2]) for r in more]
    assert rids == jrids
    got2, want2 = sess.flush_predict(), jsess.flush_predict()
    _assert_served_equal([got2[r] for r in rids], [want2[r] for r in rids],
                         serve_dtype)
    assert sess.tau_version == jsess.tau_version == 3
    _close(sess.tau_centers.numpy(), jsess.tau_centers)
    st, jst = sess.stats()["heads"], jsess.stats()["heads"]
    assert st == jst
    assert st["routed_served"] + st["overflowed"] == 15


def test_heads_on_labels_and_state_equal_heads_off(mixture, jax_round):
    """Turning heads on changes nothing of the labels, versions, folded
    state or tau (the port against itself, bit for bit)."""
    _, on = _sessions(jax_round, "granite-3-2b", "transformer")
    off = Session.from_round(
        FederationPlan(k=K, k_prime=KP, d=D, device="cpu", **SERVE),
        _port_round(jax_round), gumbel=JaxServeGumbel(0), device="cpu")
    reqs = late_device_stream(mixture.means, KP, 9, 5, n_range=(10, 60))
    datas, kvs = [r[0] for r in reqs], [r[2] for r in reqs]
    got = on.serve_predict(datas, kvs)
    want = off.serve_versioned(datas, kvs)
    for g, (lbl, ver) in zip(got, want):
        np.testing.assert_array_equal(g.labels, lbl)
        assert g.tau_version == ver
    for a, b in zip(on.service.state, off.service.state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(on.tau_centers, off.tau_centers, rtol=0,
                               atol=0)
    assert off.stats()["heads"] == {"mode": "off"}
    with pytest.raises(StreamConfigError, match="StreamConfig.heads"):
        off.serve_predict(datas[:1], kvs[:1])
    with pytest.raises(StreamConfigError, match="StreamConfig.heads"):
        off.flush_predict()


def test_default_heads_follow_the_seed(mixture):
    """Without heads=, the heads are drawn from the session seed: the
    same seed gives the same predictions, another seed others."""
    plan = FederationPlan(k=K, k_prime=KP, d=D, device="cpu",
                          heads="whisper-base", **SERVE)
    rr = Session(plan).run(0, mixture.data).detail
    reqs = late_device_stream(mixture.means, KP, 4, 6, n_range=(10, 30))
    datas, kvs = [r[0] for r in reqs], [r[2] for r in reqs]
    a = Session.from_round(plan, rr, seed=1).serve_predict(datas, kvs)
    b = Session.from_round(plan, rr, seed=1).serve_predict(datas, kvs)
    c = Session.from_round(plan, rr, seed=2).serve_predict(datas, kvs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prediction, y.prediction)
    routed = [i for i, x in enumerate(a) if x.routed and c[i].routed]
    assert routed and any(
        not np.array_equal(a[i].prediction, c[i].prediction)
        for i in routed)


@pytest.mark.parametrize("opts,field", [
    (dict(heads="no-such-config"), "heads"),
    (dict(heads="linear", head_arch="mlp"), "head_arch"),
    (dict(d=20, heads="granite-3-2b", head_arch="transformer"), "heads"),
    (dict(heads="linear", head_capacity=0.0), "head_capacity"),
    (dict(heads="linear", encoder="granite_3_2b"), "encoder"),
    (dict(heads="linear", drift="decay", drift_half_life=0),
     "drift_half_life")])
def test_plan_validates_heads(opts, field):
    """Head options are validated by name (granite's 8 attention heads
    do not divide d=20); heads combined with the encoder, which the port
    does not have, is refused by its name, and with drift, which it has,
    by the drift field that is invalid."""
    with pytest.raises(PlanError, match=f"FederationPlan.{field}="):
        FederationPlan(**{**dict(k=K, k_prime=KP, d=D, device="cpu"),
                          **opts})


# ------------------------------------------------ drift re-maps heads --

DK, DKP = 16, 4
DRIFT = dict(k=DK, k_prime=DKP, d=D, capacity=512, batch_size=4,
             bucket_sizes=(32, 64, 128), refresh_every=4,
             drift="split_merge", drift_half_life=24, drift_retire_frac=0.2,
             heads="linear")


@pytest.fixture(scope="module")
def drift_round():
    """tests/test_route_serve.py's drift fixture on the port's mixture:
    the JAX package's round and a stream from resampled means, which
    makes split/retire move a center."""
    fm = structured_devices(0, k=DK, d=D, k_prime=DKP, m0=4,
                            n_per_comp_dev=25, sep=60.0)
    jr = japi.Session(japi.FederationPlan(k=DK, k_prime=DKP, d=D)).run(
        jax.random.PRNGKey(1), jnp.asarray(fm.data)).detail
    means = np.random.default_rng(3).normal(size=(DK, D)).astype(
        np.float32) * 40.0
    stream = late_device_stream(means, DKP, 24, 19, n_range=(15, 50))
    return jr, [r[0] for r in stream], [r[2] for r in stream]


def _drift_pair(jr, **kw):
    opts = {**DRIFT, **kw}
    jsess = japi.Session.from_round(japi.FederationPlan(**opts), jr)
    heads = convert.heads(jax.tree.map(np.asarray, jsess.service.heads),
                          device="cpu")
    sess = Session.from_round(FederationPlan(device="cpu", **opts),
                              _port_round(jr), heads=heads,
                              gumbel=JaxServeGumbel(0), device="cpu")
    return jsess, sess


def _assert_heads_equal(sess, jsess):
    for a, b in zip(jax.tree.leaves(sess.service.heads),
                    jax.tree.leaves(jsess.service.heads)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("refresh", ["sync", "async"])
def test_split_retire_remaps_heads_like_jax(drift_round, refresh):
    """tests/test_route_serve.py:238 against the JAX package: under
    split_merge a re-seeded center's head starts as its donor's, through
    the tau swap that bumps the version (at once on a sync refresh, at
    the next flush on an async one). Labels, versions, clusters and
    routing exact, predictions within 1e-5 relative, the heads the JAX
    session's bit for bit after each wave; labels equal the heads-off
    drift twin's; no re-map left pending."""
    jr, datas, kvs = drift_round
    jsess, sess = _drift_pair(jr, refresh=refresh)
    plain = Session.from_round(
        FederationPlan(device="cpu", **{**DRIFT, "heads": "off",
                                        "refresh": refresh}),
        _port_round(jr), gumbel=JaxServeGumbel(0), device="cpu")
    pending = []
    for lo in range(0, 24, 6):
        got = sess.serve_predict(datas[lo:lo + 6], kvs[lo:lo + 6])
        want = jsess.serve_predict(datas[lo:lo + 6], kvs[lo:lo + 6])
        _assert_served_equal(got, want, "f32")
        for g, (lbl, ver) in zip(got, plain.serve_versioned(
                datas[lo:lo + 6], kvs[lo:lo + 6])):
            np.testing.assert_array_equal(g.labels, lbl)
            assert g.tau_version == ver
        _assert_heads_equal(sess, jsess)
        st = sess.stats()["heads"]
        assert st == jsess.stats()["heads"]
        pending.append(st["remap_pending"])
    assert sess.service._drift_moves == jsess.service._drift_moves > 0
    assert pending[-1] is False
    assert any(pending) == (refresh == "async")
    assert sess.tau_version == jsess.tau_version == plain.tau_version > 0


def test_pending_heads_perm_survives_save_and_restore(drift_round,
                                                      tmp_path):
    """An async split/retire refresh leaves its head re-map staged with
    the tau swap; a save there carries ``heads_perm``. The JAX package's
    archive restores in the port with the re-map pending and serves
    JAX's continuation; the port's archive restores in the port (bit for
    bit against the uninterrupted session) and in the JAX package."""
    from repro_torch.checkpoint.store import npz_keys
    jr, datas, kvs = drift_round
    jsess, sess = _drift_pair(jr, refresh="async")
    for lo in (0, 6, 12):
        sess.serve_predict(datas[lo:lo + 6], kvs[lo:lo + 6])
        jsess.serve_predict(datas[lo:lo + 6], kvs[lo:lo + 6])
    assert sess.stats()["heads"]["remap_pending"] is True
    jpath = jsess.save(str(tmp_path / "jax_perm.npz"))
    path = sess.save(str(tmp_path / "port_perm.npz"))
    assert "heads_perm" in npz_keys(jpath) and \
        npz_keys(path) == npz_keys(jpath)
    with np.load(path) as a, np.load(jpath) as b:
        np.testing.assert_array_equal(a["heads_perm"], b["heads_perm"])
    plan = FederationPlan(device="cpu", **{**DRIFT, "refresh": "async"})
    jplan = japi.FederationPlan(**{**DRIFT, "refresh": "async"})
    from_jax = Session.restore(jpath, plan, gumbel=JaxServeGumbel(0))
    from_port = Session.restore(path, plan, gumbel=JaxServeGumbel(0))
    in_jax = japi.Session.restore(path, jplan)
    for s in (from_jax, from_port):
        assert s.stats()["heads"]["remap_pending"] is True
        np.testing.assert_array_equal(s.service._heads_perm,
                                      sess.service._heads_perm)
    rest = (datas[18:], kvs[18:])
    want = jsess.serve_predict(*rest)
    live = sess.serve_predict(*rest)
    _assert_served_equal(live, want, "f32")
    _assert_served_equal(from_jax.serve_predict(*rest), want, "f32")
    _assert_served_equal(in_jax.serve_predict(*rest), want, "f32")
    again = from_port.serve_predict(*rest)
    for g, w in zip(again, live):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.prediction, w.prediction)
        assert (g.tau_version, g.cluster, g.routed) == (
            w.tau_version, w.cluster, w.routed)
    for x, y in zip(jax.tree.leaves(from_port.service.heads),
                    jax.tree.leaves(sess.service.heads)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert from_port.stats()["heads"]["remap_pending"] is False
