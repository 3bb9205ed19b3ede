"""The drift layer of the port (repro_torch/core/server.py decay and
split/retire, repro_torch/fed/stream.py drift refresh) against the JAX
package's, on the same numpy inputs, round and k-means++ draws.

Exact: the zero set of the decay factors, the decayed evidence mask,
finalize's labels, the split/retire decisions (``take``, donors, move
count), served labels, tau versions and the drift counters. Within 1e-5
relative (of the largest magnitude): decay factors, tau and the
per-center mass (f32 sums added in another order). The reference's rule
is that a slot whose decayed weight underflows to 0 is masked out; XLA
on the CPU gives 0 for 2^x at x <= -126 and flushes subnormal products,
so the port writes both cutoffs out.

The accuracy margin of tests/test_drift.py's
``test_decayed_refresh_tracks_recent_distribution`` is not carried
over: it fails in the JAX package itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import server as J  # noqa: E402
from repro.fed import api as japi  # noqa: E402
from repro.fed.policy import WeightedReservoirPolicy as JaxReservoir  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import server as S  # noqa: E402
from repro_torch.data.gaussian import (late_device_stream,  # noqa: E402
                                       structured_devices)
from repro_torch.fed.api import FederationPlan, PlanError, Session  # noqa: E402
from repro_torch.fed.policy import WeightedReservoirPolicy  # noqa: E402
from test_torch_prng import JaxServeGumbel  # noqa: E402

RTOL = 1e-5


def _rel_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _jstate(st):
    return J.ServerState(*(jnp.asarray(t.numpy()) for t in st))


def _random_state(seed, Z=24, kp=3, d=5, spread=400):
    """A fold state with every slot received, epochs spread over
    ``spread`` requests and weights in [0.5, 3) (some rows unmasked)."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(Z, kp, d)) * 10).astype(np.float32)
    centers += (rng.integers(0, 4, size=(Z, 1, 1)) * 40).astype(np.float32)
    mask = rng.random((Z, kp)) < 0.85
    w = (0.5 + 2.5 * rng.random((Z, kp))).astype(np.float32)
    ep = rng.integers(0, spread, size=Z).astype(np.int32)
    st = S.aggregate_incremental(
        S.init_state(Z, kp, d, device="cpu"), torch.arange(Z),
        torch.as_tensor(centers), torch.as_tensor(mask),
        weights=torch.as_tensor(w), epochs=torch.as_tensor(ep))
    return st


# ------------------------------------------------------- the functions --


@pytest.mark.parametrize("h", (1, 3, 24, 64))
def test_decay_factors_zero_set_matches_jax(h):
    """Ages 0..130h: the exact zeros are JAX's (every exponent <= -126),
    the other factors within 1e-5 relative."""
    now = 130 * h
    ep = np.arange(now + 1, dtype=np.int32)
    want = np.asarray(J.decay_factors(jnp.asarray(ep), now, h))
    got = S.decay_factors(torch.as_tensor(ep), now, h).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want == 0).sum() == now - 126 * h + 1
    nz = want > 0
    np.testing.assert_allclose(got[nz], want[nz], rtol=RTOL, atol=0)


@pytest.mark.parametrize("h,scale", [(7, 1.0), (24, 1e-30), (3, 1e-37)])
def test_decayed_evidence_mask_matches_jax(h, scale):
    """The mask exactly, the decayed weights within 1e-5 relative; with
    weights near the bottom of f32 the products go subnormal, which XLA
    flushes to 0 and the port too."""
    st = _random_state(h)
    st = st._replace(weights=st.weights * scale)
    now = int(st.epoch.max()) + 5
    jm, jw = J.decayed_evidence(_jstate(st), now, h)
    m, w = S.decayed_evidence(st, now, h)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(w.numpy() == 0, np.asarray(jw) == 0)
    _rel_close(w.numpy(), jw)
    if scale < 1e-36:
        assert 0 < int(m.sum()) < int((st.mask & st.received[:, None]).sum())


@pytest.mark.parametrize("h", (8, 40))
def test_finalize_decay_matches_jax(h):
    """Labels exact, tau within 1e-5 of its largest entry."""
    st = _random_state(10 + h)
    now = int(st.epoch.max()) + 3
    want = J.finalize(_jstate(st), 6, decay=(now, h))
    got = S.finalize(st, 6, decay=(now, h))
    np.testing.assert_array_equal(got.center_labels.numpy(),
                                  np.asarray(want.center_labels))
    np.testing.assert_array_equal(got.seeds_idx.numpy(),
                                  np.asarray(want.seeds_idx))
    _rel_close(got.tau_centers.numpy(), want.tau_centers)


def test_finalize_decay_keeps_a_nan_slot_out():
    """tests/test_drift.py:97 in the port: a fully decayed slot holding
    NaN neither seeds, anchors nor poisons tau, and its label is -1."""
    st = S.init_state(3, 1, 2, device="cpu")
    st = S.aggregate_incremental(st, [0], torch.full((1, 1, 2), float("nan")),
                                 torch.ones((1, 1), dtype=torch.bool),
                                 epochs=[0])
    st = S.aggregate_incremental(
        st, [1, 2], torch.tensor([[[1.0, 2.0]], [[5.0, 6.0]]]),
        torch.ones((2, 1), dtype=torch.bool), epochs=[100_000, 100_000])
    agg = S.finalize(st, 2, decay=(100_000, 10))
    assert bool(torch.isfinite(agg.tau_centers).all())
    lbl = agg.center_labels.reshape(-1).tolist()
    assert lbl[0] == -1 and set(lbl[1:]) == {0, 1}
    mask, w = S.decayed_evidence(st, 100_000, 10)
    assert not bool(mask[0, 0]) and float(w[0, 0]) == 0.0
    want = J.finalize(_jstate(st), 2, decay=(100_000, 10))
    np.testing.assert_array_equal(agg.tau_centers.numpy(),
                                  np.asarray(want.tau_centers))


@pytest.mark.parametrize("seed", (0, 1))
def test_center_mass_matches_jax(seed):
    st = _random_state(20 + seed)
    now, h = int(st.epoch.max()), 50
    agg = S.finalize(st, 5, decay=(now, h))
    m, w = S.decayed_evidence(st, now, h)
    got = S.center_mass(agg, m, w).numpy()
    jst = _jstate(st)
    jagg = J.finalize(jst, 5, decay=(now, h))
    jm, jw = J.decayed_evidence(jst, now, h)
    want = np.asarray(J.center_mass(jagg, jm, jw))
    assert got.shape == (5,) and got.dtype == np.float32
    _rel_close(got, want)


def _split_inputs(seed, k=6):
    """(flat, fm, agg, mass, weights) of a decayed random state, the same
    in both packages; the JAX aggregate is carried over by convert."""
    st = _random_state(30 + seed, Z=30)
    now, h = int(st.epoch.max()), 60
    jst = _jstate(st)
    jagg = J.finalize(jst, k, decay=(now, h))
    jm, jw = J.decayed_evidence(jst, now, h)
    jmass = J.center_mass(jagg, jm, jw)
    flat = np.where(np.asarray(jm)[..., None], np.asarray(jst.centers),
                    0.0).reshape(-1, st.centers.shape[-1]).astype(np.float32)
    return (flat, np.asarray(jm).reshape(-1),
            jax.tree.map(np.asarray, jagg), np.asarray(jmass),
            np.asarray(jw).reshape(-1))


def _both_split_retire(flat, fm, jagg, mass, k, **kw):
    want = J.split_retire(jnp.asarray(flat), jnp.asarray(fm),
                          J.KFedAggregate(*map(jnp.asarray, jagg)),
                          jnp.asarray(mass), k, **kw)
    agg = convert.aggregate(jagg, device="cpu")
    got = S.split_retire(torch.tensor(flat), torch.tensor(fm), agg,
                         torch.tensor(mass), k, **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want], agg


@pytest.mark.parametrize("case", ["moves", "donor_without_reports",
                                  "zero_moves"])
def test_split_retire_matches_jax(case):
    """``take``, donors and the move count exact, tau within 1e-5
    relative. ``donor_without_reports``: the fattest center has no
    attached report (a mass handed in), so its column of scores is all
    -inf and the re-seed takes row 0, as jnp.argmax does.
    ``zero_moves``: tau is the aggregate's bit for bit."""
    k = 6
    flat, fm, jagg, mass, w = _split_inputs(0, k)
    kw = dict(split_factor=1.3, retire_frac=0.6, max_moves=2)
    lbl = jagg.center_labels.reshape(-1)
    if case == "donor_without_reports":
        empty = [c for c in range(k) if not ((lbl == c) & fm).any()]
        if not empty:   # free a center: detach its reports
            c = int(lbl[fm][0])
            fm = fm & (lbl != c)
            empty = [c]
        mass = np.full((k,), 1.0, np.float32)
        mass[empty[0]] = 10.0                      # the only donor
        mass[(empty[0] + 1) % k] = 0.01            # the only starved
    if case == "zero_moves":
        kw.update(split_factor=100.0, retire_frac=0.0)
    got, want, agg = _both_split_retire(flat, fm, jagg, mass, k, **kw)
    tau, take, donors, n_mv = got
    np.testing.assert_array_equal(take, want[1])
    np.testing.assert_array_equal(donors, want[2])
    assert int(n_mv) == int(want[3]) and n_mv.dtype == np.int32
    assert donors.dtype == np.int32
    _rel_close(tau, want[0])
    if case == "zero_moves":
        assert int(n_mv) == 0
        np.testing.assert_array_equal(tau, agg.tau_centers.numpy())
    else:
        assert int(n_mv) >= 1
    if case == "donor_without_reports":
        moved = int(np.nonzero(take)[0][0])
        assert donors[moved] == int(np.argmax(mass))


def test_split_retire_weighted_matches_jax():
    """With the decayed weights as Lloyd weights, as the stream calls it."""
    k = 6
    flat, fm, jagg, mass, w = _split_inputs(1, k)
    kw = dict(split_factor=1.2, retire_frac=0.7, max_moves=3)
    want = J.split_retire(jnp.asarray(flat), jnp.asarray(fm),
                          J.KFedAggregate(*map(jnp.asarray, jagg)),
                          jnp.asarray(mass), k, weights=jnp.asarray(w), **kw)
    got = S.split_retire(torch.tensor(flat), torch.tensor(fm),
                         convert.aggregate(jagg, device="cpu"),
                         torch.tensor(mass), k, weights=torch.tensor(w),
                         **kw)
    for g, wv in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    _rel_close(got[0].numpy(), want[0])


# ------------------------------------------------------------ sessions --

K, KP, D = 16, 4, 24


def _jplan(**kw):
    return japi.FederationPlan(**{**dict(k=K, k_prime=KP, d=D, capacity=512,
                                         batch_size=4,
                                         bucket_sizes=(32, 64, 128)), **kw})


def _plan(**kw):
    return FederationPlan(**{**dict(k=K, k_prime=KP, d=D, capacity=512,
                                    batch_size=4,
                                    bucket_sizes=(32, 64, 128),
                                    device="cpu"), **kw})


@pytest.fixture(scope="module")
def fixture_round():
    """tests/test_drift.py's fixture round on the port's mixture: the
    JAX package's round, and the port's copy of it."""
    fm = structured_devices(0, k=K, d=D, k_prime=KP, m0=4,
                            n_per_comp_dev=25, sep=60.0)
    jr = japi.Session(japi.FederationPlan(k=K, k_prime=KP, d=D)).run(
        jax.random.PRNGKey(1), jnp.asarray(fm.data)).detail
    return fm, jr, convert.round_result(jax.tree.map(np.asarray, jr),
                                        device="cpu")


def _shifted(count, seed, n_range=(15, 50), means_seed=3):
    """Requests from a resampled mixture (same k, new means x40)."""
    rng = np.random.default_rng(means_seed)
    means = rng.normal(size=(K, D)).astype(np.float32) * 40.0
    s = late_device_stream(means, KP, count, seed, n_range=n_range)
    return [r[0] for r in s], [r[2] for r in s]


def _pair(fixture_round, **kw):
    _, jr, rr = fixture_round
    return (japi.Session.from_round(_jplan(**kw), jr),
            Session.from_round(_plan(**kw), rr, gumbel=JaxServeGumbel(0)))


def _assert_served(got, want):
    assert len(got) == len(want)
    for i, ((g, gv), (w, wv)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(i))
        assert gv == wv, (i, gv, wv)


def _assert_drift_state(svc, jsvc):
    assert (svc._drift_events, svc._drift_moves, svc._drift_last) == (
        jsvc._drift_events, jsvc._drift_moves, jsvc._drift_last)
    _rel_close(svc._drift_mass, jsvc._drift_mass)


DRIFTS = {"decay": dict(drift="decay", drift_half_life=16, refresh_every=4),
          "split_merge": dict(drift="split_merge", drift_half_life=24,
                              drift_retire_frac=0.2, refresh_every=4)}


@pytest.mark.parametrize("mode", sorted(DRIFTS))
def test_drift_session_matches_jax(fixture_round, mode):
    """Serve a resampled stream under decay and split_merge: labels, tau
    versions, drift events and moves exactly, mass within 1e-5
    relative, tau within 1e-4 of its largest entry, the stats' drift
    block alike."""
    jsess, sess = _pair(fixture_round, **DRIFTS[mode])
    datas, kvs = _shifted(24, 19)
    for lo in range(0, 24, 6):
        _assert_served(sess.serve_versioned(datas[lo:lo + 6], kvs[lo:lo + 6]),
                       jsess.serve_versioned(datas[lo:lo + 6],
                                             kvs[lo:lo + 6]))
    svc, jsvc = sess.service, jsess.service
    _assert_drift_state(svc, jsvc)
    assert sess.tau_version == jsess.tau_version >= 4
    _rel_close(sess.tau_centers.numpy(), jsess.tau_centers, 1e-4)
    st, jst = sess.stats()["drift"], jsess.stats()["drift"]
    assert {k: v for k, v in st.items() if k != "mass"} == {
        k: v for k, v in jst.items() if k != "mass"}
    for a, b in zip(svc.state[1:], jsvc.state[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if mode == "split_merge":
        assert svc._drift_events > 0 and svc._drift_moves > 0
    assert sum(st["mass"]) > 0


def test_split_merge_replays_bitwise_from_checkpoint(fixture_round,
                                                     tmp_path):
    """tests/test_drift.py:244 in the port: save a split_merge stream at
    a flush boundary and restore; labels, tau versions, fold state, mass
    and the counters replay bit for bit against the uninterrupted
    session."""
    _, _, rr = fixture_round
    plan = _plan(**DRIFTS["split_merge"])
    datas, kvs = _shifted(24, 19)
    live = Session.from_round(plan, rr, seed=4)
    live.serve_versioned(datas[:6], kvs[:6])
    live.serve_versioned(datas[6:12], kvs[6:12])
    path = live.save(str(tmp_path / "drift.npz"))
    replica = Session.restore(path, plan)
    for lo in (12, 18):
        _assert_served(replica.serve_versioned(datas[lo:lo + 6],
                                               kvs[lo:lo + 6]),
                       live.serve_versioned(datas[lo:lo + 6],
                                            kvs[lo:lo + 6]))
    a, b = live.service, replica.service
    for x, y in zip(a.state, b.state):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (a._drift_events, a._drift_moves, a._drift_last) == (
        b._drift_events, b._drift_moves, b._drift_last)
    np.testing.assert_array_equal(a._drift_mass, b._drift_mass)
    assert a._drift_events > 0


@pytest.mark.parametrize("mode", sorted(DRIFTS))
def test_jax_drift_archive_restores_and_replays(fixture_round, tmp_path,
                                                mode):
    """A v4 archive the JAX package wrote under decay or split_merge
    (once refused by the port) restores in the port with its fold
    epochs, mass and counters, and serves JAX's continuation: labels,
    versions and the drift counters exact."""
    fm, jr, _ = fixture_round
    datas, kvs = _shifted(20, 23)
    jsess = japi.Session.from_round(_jplan(**DRIFTS[mode]), jr)
    jsess.serve(datas[:10], kvs[:10])
    path = jsess.save(str(tmp_path / "jax_drift.npz"))
    sess = Session.restore(path, _plan(**DRIFTS[mode]),
                           gumbel=JaxServeGumbel(0))
    svc, jsvc = sess.service, jsess.service
    for a, b in zip(svc.state, jsvc.state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(svc._drift_mass, jsvc._drift_mass)
    _assert_drift_state(svc, jsvc)
    _assert_served(sess.serve_versioned(datas[10:], kvs[10:]),
                   jsess.serve_versioned(datas[10:], kvs[10:]))
    _assert_drift_state(svc, jsvc)
    other = "decay" if mode == "split_merge" else "split_merge"
    with pytest.raises(Exception, match="StreamConfig.drift"):
        Session.restore(path, _plan(**DRIFTS[other]))


def test_port_drift_archive_restores_in_jax(fixture_round, tmp_path):
    """The port's split_merge archive has the JAX package's keys and
    arrays, restores there, and both serve the rest alike."""
    from repro.checkpoint.store import npz_keys
    _, jr, rr = fixture_round
    kw = DRIFTS["split_merge"]
    datas, kvs = _shifted(20, 29)
    sess = Session.from_round(_plan(**kw), rr, gumbel=JaxServeGumbel(0))
    jref = japi.Session.from_round(_jplan(**kw), jr)
    sess.serve(datas[:12], kvs[:12])
    jref.serve(datas[:12], kvs[:12])
    path = sess.save(str(tmp_path / "port_drift.npz"))
    jpath = jref.save(str(tmp_path / "jax_ref.npz"))
    assert npz_keys(path) == npz_keys(jpath)
    with np.load(path) as a, np.load(jpath) as b:
        for key in ("drift_id", "drift_state", "server/.epoch",
                    "server/.received", "counters"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        _rel_close(a["drift_mass"], b["drift_mass"])
    jsess = japi.Session.restore(path, _jplan(**kw))
    _assert_served(sess.serve_versioned(datas[12:], kvs[12:]),
                   jsess.serve_versioned(datas[12:], kvs[12:]))
    _assert_drift_state(sess.service, jsess.service)


def test_pre_v4_archive_restores_into_a_drift_plan(fixture_round, tmp_path):
    """An archive without the drift arrays (pre-v4: no epochs either)
    restores under split_merge with the drift state at its defaults and
    the epochs at 0, as the JAX package restores it."""
    from repro.checkpoint import store as jstore
    from repro.fed.stream import _ServerStateV3
    _, jr, _ = fixture_round
    datas, kvs = _shifted(12, 31)
    base = japi.Session.from_round(_jplan(refresh_every=4), jr)
    base.serve(datas[:4], kvs[:4])
    svc = base.service
    path = jstore.save_pytree(str(tmp_path / "v2.npz"), {
        "tau_bufs": svc._taubuf.bufs, "tau_meta": svc._taubuf.meta_array(),
        "server": _ServerStateV3(*tuple(svc.state)[:4]),
        "counters": svc._counters()})
    kw = DRIFTS["split_merge"]
    sess = Session.restore(path, _plan(**kw), gumbel=JaxServeGumbel(0))
    jsess = japi.Session.restore(path, _jplan(**kw))
    assert sess.stats()["drift"]["events"] == 0
    assert int(sess.service.state.epoch.abs().sum()) == 0
    _assert_served(sess.serve_versioned(datas[4:], kvs[4:]),
                   jsess.serve_versioned(datas[4:], kvs[4:]))
    _assert_drift_state(sess.service, jsess.service)


@pytest.mark.parametrize("seed", (0, 5))
def test_decayed_reservoir_key_matches_jax(seed):
    """The weighted reservoir's key under a drift half-life equals the
    JAX package's, and so do the survivors; a drift plan hands the
    policy its half-life."""
    ours = WeightedReservoirPolicy(4, seed=seed, half_life=4)
    theirs = JaxReservoir(4, seed=seed, half_life=4)
    for rid in (0, 7, 63, 500):
        for w in (0.5, 1.0, 3.0):
            assert ours.key_of(rid, w) == theirs.key_of(rid, w)
    for rid in range(64):
        ours.admit(rid, 1.0 + rid % 3)
        theirs.admit(rid, 1.0 + rid % 3)
    np.testing.assert_array_equal(np.asarray(ours._slot_rid),
                                  np.asarray(theirs._slot_rid))
    assert min(int(r) for r in ours._slot_rid if r >= 0) >= 32
    plan = _plan(fold_policy="weighted_reservoir", drift="decay",
                 drift_half_life=9)
    rr = Session(_plan()).run(0, structured_devices(
        1, k=K, d=D, k_prime=KP, m0=1, n_per_comp_dev=5, sep=60.0).data)
    sess = Session.from_round(plan, rr.detail)
    assert sess.service.policy.half_life == 9
    assert Session.from_round(_plan(fold_policy="weighted_reservoir"),
                              rr.detail).service.policy.half_life == 0


@pytest.mark.parametrize("bad", [
    dict(drift="decay"), dict(drift="decay", drift_half_life=0),
    dict(drift="split_merge", drift_half_life=8, drift_split_factor=1.0),
    dict(drift="split_merge", drift_half_life=8, drift_retire_frac=1.0),
    dict(drift="split_merge", drift_half_life=8, drift_max_moves=0),
    dict(drift="sideways")])
def test_drift_plan_validation_names_the_field(bad):
    """tests/test_drift.py's validation cases, each refused by name."""
    with pytest.raises(PlanError, match="FederationPlan.drift"):
        _plan(**bad)
