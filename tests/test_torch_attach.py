"""The serving options of the attachment server (the lru and
weighted_reservoir admission policies, the async refresh, latency and
throughput autoscaling), Session.attach_fn and the attachment server's
entry point, against the JAX package on the same numpy traffic and
k-means++ draws.

Tolerances (set before the runs): labels, tau versions, the decision
sequence, policy state, the fold state's integer leaves and stats()
(the telemetry's microseconds aside) exactly; tau and the folded centers
within 1e-5 of their largest magnitude (f32 sums in another order). A
restored session against the uninterrupted one: bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import api as japi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.gaussian import (late_device_stream,  # noqa: E402
                                       structured_devices)
from repro_torch.fed.api import FederationPlan, Session  # noqa: E402
from repro_torch.launch import attach_server  # noqa: E402
from test_torch_prng import JaxKeyGumbel, JaxServeGumbel  # noqa: E402

K, KP, D = 12, 3, 24
BURSTS = (1, 2, 3, 5, 8, 13)
SERVE = dict(capacity=10, batch_size=4, bucket_sizes=(32, 64),
             refresh_every=4)
MODES = {
    "lru-async-throughput": dict(fold_policy="lru", refresh="async",
                                 autoscale="throughput"),
    "reservoir-sync-latency": dict(fold_policy="weighted_reservoir",
                                   refresh="sync", autoscale="latency",
                                   policy_seed=5),
    "reservoir-async-latency": dict(fold_policy="weighted_reservoir",
                                    refresh="async", autoscale="latency"),
}
TELEMETRY = ("last_dispatch_us", "last_materialize_us")


@pytest.fixture(scope="module")
def mixture():
    return structured_devices(0, k=K, d=D, k_prime=KP, m0=2,
                              n_per_comp_dev=12, sep=30.0)


@pytest.fixture(scope="module")
def jax_round(mixture):
    return japi.Session(japi.FederationPlan(k=K, k_prime=KP, d=D)).run(
        jax.random.PRNGKey(1), jnp.asarray(mixture.data)).detail


@pytest.fixture(scope="module")
def traffic(mixture):
    """Bursts of late devices of 10-150 points over the (32, 64) ladder:
    the oversized ones pad to 128 and 256, which throughput coalesces."""
    reqs = late_device_stream(mixture.means, KP, sum(BURSTS), 3,
                              n_range=(10, 150))
    out, lo = [], 0
    for b in BURSTS:
        out.append(reqs[lo:lo + b])
        lo += b
    return out


def _sessions(jax_round, mode):
    kw = {**SERVE, **MODES[mode]}
    jsess = japi.Session.from_round(
        japi.FederationPlan(k=K, k_prime=KP, d=D, **kw), jax_round)
    rr = convert.round_result(jax.tree.map(np.asarray, jax_round),
                              device="cpu")
    sess = Session.from_round(
        FederationPlan(k=K, k_prime=KP, d=D, device="cpu", **kw), rr,
        gumbel=JaxServeGumbel(0), device="cpu")
    return sess, jsess


def _burst(sess, reqs):
    """Submit one burst and flush it: {rid: (labels, version)} and the
    flush's decision."""
    for r in reqs:
        sess.submit(r[0], r[2])
    out = sess.flush_versioned()
    return out, sess.service.autoscaler.decision


def _same_served(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid][0], np.asarray(want[rid][0]),
                                      err_msg=f"request {rid}")
        assert got[rid][1] == want[rid][1], rid


def _stats(sess, restored=False):
    st = dict(sess.stats())
    if restored:   # a restored plane counts its own shapes from zero
        st.pop("plane_compiles")
    st["autoscale"] = {k: v for k, v in st["autoscale"].items()
                       if k not in TELEMETRY}
    for k in ("serve_device", "plane_steps", "plane_folds"):
        st.pop(k, None)   # the port's own, not in the JAX package
    return st


def _same_state(sess, jsess, restored=False):
    svc, jsvc = sess.service, jsess.service
    for name, arr in jsvc.policy.state_arrays().items():
        np.testing.assert_array_equal(svc.policy.state_arrays()[name], arr)
    for a, b in zip(svc.state[1:], jsvc.state[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((svc.state.centers, jsvc.state.centers),
                 (svc._taubuf.bufs, jsvc._taubuf.bufs)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    assert (svc._taubuf.active, svc._taubuf.version, svc._taubuf.pending) \
        == (jsvc._taubuf.active, jsvc._taubuf.version, jsvc._taubuf.pending)
    assert _stats(sess, restored) == _stats(jsess, restored)


def _cut(sess, traffic):
    """Serve bursts until an async refresh is staged (or all but the
    last two under sync); returns the index of the next burst."""
    for i, reqs in enumerate(traffic[:-2]):
        _burst(sess, reqs)
        if sess.service._taubuf.pending:
            return i + 1
    return len(traffic) - 2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bursty_traffic_and_archives_serve_as_jax(jax_round, traffic,
                                                  tmp_path, mode):
    """Each burst, one flush: labels, versions and the flush's decision
    equal the JAX Session's; after each, the policy's slots, the fold
    state, the tau buffers and stats(). Both save at the cut (under
    async with a refresh staged, not yet committed); the port restores
    the JAX package's archive and the JAX package the port's, and all
    four sessions serve the remaining bursts alike."""
    sess, jsess = _sessions(jax_round, mode)
    kw = {**SERVE, **MODES[mode]}
    # (port session, JAX session, restored): the live pair, then from
    # the cut the port's restore of the JAX archive against the live
    # JAX session, and the live port session against the JAX restore.
    pairs, decisions = [(sess, jsess, False)], []
    for i, reqs in enumerate(traffic):
        served = {}
        for s_ in {id(x): x for pair in pairs for x in pair[:2]}.values():
            served[id(s_)] = _burst(s_, reqs)
        for got_sess, want_sess, restored in pairs:
            (got, dec), (want, jdec) = (served[id(got_sess)],
                                        served[id(want_sess)])
            _same_served(got, want)
            assert tuple(dec) == tuple(jdec)
            _same_state(got_sess, want_sess, restored)
        decisions.append(served[id(sess)][1])
        if len(pairs) == 1 and (jsess.service._taubuf.pending
                                or i == len(traffic) - 3):
            if MODES[mode]["refresh"] == "async":
                assert jsess.service._taubuf.pending
            from_jax = Session.restore(
                jsess.save(str(tmp_path / "jax.npz")),
                FederationPlan(k=K, k_prime=KP, d=D, device="cpu", **kw),
                gumbel=JaxServeGumbel(0))
            from_port = japi.Session.restore(
                sess.save(str(tmp_path / "port.npz")),
                japi.FederationPlan(k=K, k_prime=KP, d=D, **kw))
            for a, b in ((from_jax, jsess), (from_port, sess)):
                assert a.service._taubuf.pending == b.service._taubuf.pending
            pairs += [(from_jax, jsess, True), (sess, from_port, True)]
    assert len(pairs) == 3
    st = sess.stats()
    assert st["served_devices"] == sum(BURSTS)
    assert st["autoscale"]["decisions"] == len(BURSTS)
    assert sess.tau_version >= 2
    assert len({(d.batch_size, d.ladder) for d in decisions}) > 2


@pytest.mark.parametrize("mode", ["lru-async-throughput",
                                  "reservoir-async-latency"])
def test_port_restore_replays_itself_bit_for_bit(jax_round, traffic,
                                                 tmp_path, mode):
    """Save with a refresh staged, restore with the archive's own draws
    (no gumbel given): the rest of the traffic, the fold state and the
    tau buffers equal the uninterrupted session's bit for bit."""
    kw = {**SERVE, **MODES[mode]}
    plan = FederationPlan(k=K, k_prime=KP, d=D, device="cpu", **kw)
    rr = convert.round_result(jax.tree.map(np.asarray, jax_round),
                              device="cpu")
    live = Session.from_round(plan, rr, seed=4, device="cpu")
    cut = _cut(live, traffic)
    assert live.service._taubuf.pending
    restored = Session.restore(live.save(str(tmp_path / "self")), plan)
    for reqs in traffic[cut:]:
        got, dec = _burst(restored, reqs)
        want, wdec = _burst(live, reqs)
        assert sorted(got) == sorted(want) and dec == wdec
        for rid in want:
            np.testing.assert_array_equal(got[rid][0], want[rid][0])
            assert got[rid][1] == want[rid][1]
    for a, b in zip(restored.service.state, live.service.state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(restored.service._taubuf.bufs,
                               live.service._taubuf.bufs, rtol=0, atol=0)


@pytest.mark.parametrize("serve_dtype", ["f32", "bf16"])
def test_attach_fn_equals_jax(mixture, jax_round, serve_dtype):
    """The closure labels a device as the JAX closure does on the same
    key, against the round's tau."""
    jsess = japi.Session.from_round(japi.FederationPlan(
        k=K, k_prime=KP, d=D, serve_dtype=serve_dtype), jax_round)
    sess = Session.from_round(
        FederationPlan(k=K, k_prime=KP, d=D, device="cpu",
                       serve_dtype=serve_dtype),
        convert.round_result(jax.tree.map(np.asarray, jax_round),
                             device="cpu"), device="cpu")
    jfn, fn = jsess.attach_fn(), sess.attach_fn()
    reqs = late_device_stream(mixture.means, KP, 3, 12, n_range=(20, 90))
    for i, (data, _, _) in enumerate(reqs):
        key = jax.random.PRNGKey(40 + i)
        want = np.asarray(jfn(key, jnp.asarray(data)))
        got = fn(JaxKeyGumbel(key), data)
        assert got.dtype == torch.int32 and got.shape == (data.shape[0],)
        np.testing.assert_array_equal(got.numpy(), want)
    own = fn(3, reqs[0][0])       # an int key: the port's own draws
    torch.testing.assert_close(own, fn(3, reqs[0][0]), rtol=0, atol=0)


def test_attach_server_runs_on_the_cpu(tmp_path, capsys):
    """The entry point end to end on the CPU, with the options the README
    shows: the restored session serves bit for bit alike."""
    attach_server.main([
        "--requests", "24", "--fold-policy", "lru", "--capacity", "20",
        "--refresh", "async", "--autoscale", "throughput", "--checkpoint",
        str(tmp_path / "attach.npz"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "uninterrupted session: True" in out
    assert "autoscale[throughput]: active shards 1/1" in out
    assert "stats: 24 served, 20 folded (capacity 20, policy lru)" in out
    assert '"solve_attach": 0' in out     # no kernel launched on the CPU


def test_attach_server_routed_heads_on_the_cpu(capsys):
    attach_server.main(["--requests", "8", "--heads", "linear",
                        "--autoscale", "latency", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "heads[linear/ffn]: routed" in out
    assert "stats: 8 served" in out
