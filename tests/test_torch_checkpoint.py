"""Checkpoints across the two packages: the port's npz store
(repro_torch/checkpoint/store.py) and Session.save / Session.restore
against the JAX package's.

An archive the JAX package writes (schemas v1-v5: drift off, decay or
split_merge, heads off or on) restores in the port, and an archive the port writes restores in
the JAX package; tests/test_torch_attach.py does the same for archives
of the lru and weighted_reservoir policies, the async refresh and
autoscaling. After
a restore both serve the same requests: labels, tau versions, clusters,
routing and counters exactly; the restored fold state and tau buffers
bit for bit; predictions within 1e-5 of their largest magnitude (f32
heads, products summed in another order). An archive the port cannot
honour is refused with a StreamConfigError naming the field.
"""
import ast
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.fed import api as japi  # noqa: E402
from repro.fed.policy import POLICY_IDS as JAX_POLICY_IDS  # noqa: E402
from repro.fed.stream import AUTOSCALE_IDS as JAX_AUTOSCALE_IDS  # noqa: E402
from repro.fed.stream import DRIFT_IDS as JAX_DRIFT_IDS  # noqa: E402
from repro.fed.stream import _ServerStateV3  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data.gaussian import (late_device_stream,  # noqa: E402
                                       structured_devices)
from repro_torch.fed import policy, stream  # noqa: E402
from repro_torch.fed.api import FederationPlan, Session, SessionError  # noqa: E402
from repro_torch.fed.stream import StreamConfigError  # noqa: E402
from test_torch_prng import JaxServeGumbel  # noqa: E402

K, KP, D = 12, 3, 24
SERVE = dict(batch_size=4, bucket_sizes=(32, 64), refresh_every=4)
HEADS = dict(heads="qwen1.5-0.5b", head_arch="transformer")
ROOT = Path(__file__).resolve().parents[1]


class _Pair(NamedTuple):
    p: object
    q: object


def _jplan(**kw):
    return japi.FederationPlan(k=K, k_prime=KP, d=D, **{**SERVE, **kw})


def _plan(**kw):
    return FederationPlan(k=K, k_prime=KP, d=D, device="cpu",
                          **{**SERVE, **kw})


@pytest.fixture(scope="module")
def mixture():
    return structured_devices(0, k=K, d=D, k_prime=KP, m0=2,
                              n_per_comp_dev=12, sep=30.0)


@pytest.fixture(scope="module")
def jax_round(mixture):
    return japi.Session(japi.FederationPlan(k=K, k_prime=KP, d=D)).run(
        jax.random.PRNGKey(1), jnp.asarray(mixture.data)).detail


@pytest.fixture(scope="module")
def requests(mixture):
    reqs = late_device_stream(mixture.means, KP, 10, 3, n_range=(10, 60))
    return [r[0] for r in reqs], [r[2] for r in reqs]


def _served(jax_round, requests, **kw):
    """A JAX session from the round that served the first 5 requests."""
    datas, kvs = requests
    sess = japi.Session.from_round(_jplan(**kw), jax_round)
    if kw.get("heads", "off") == "off":
        sess.serve(datas[:5], kvs[:5])
    else:
        sess.serve_predict(datas[:5], kvs[:5])
    return sess


@pytest.fixture(scope="module")
def archives(jax_round, requests, tmp_path_factory):
    """JAX-written archives of schemas v1-v5 of one serving state, with
    the state each was saved from (numpy)."""
    tmp = tmp_path_factory.mktemp("archives")
    base = _served(jax_round, requests)
    svc = base.service
    old_srv = _ServerStateV3(svc.state.centers, svc.state.mask,
                             svc.state.weights, svc.state.received)
    common = {"server": old_srv, "counters": svc._counters(),
              "policy_id": np.asarray(JAX_POLICY_IDS["drop"], np.int64),
              "policy": {}}
    bufs = {"tau_bufs": svc._taubuf.bufs,
            "tau_meta": svc._taubuf.meta_array()}
    paths = {"v1": jstore.save_pytree(str(tmp / "v1.npz"),
                                      {"tau": svc.tau, **common}),
             "v2": jstore.save_pytree(str(tmp / "v2.npz"),
                                      {**bufs, **common}),
             "v3": jstore.save_pytree(str(tmp / "v3.npz"), {
                 **bufs, **common,
                 "autoscale_id": np.asarray(JAX_AUTOSCALE_IDS["off"],
                                            np.int64),
                 **svc.autoscaler.state_arrays()}),
             "v4": base.save(str(tmp / "v4.npz"))}
    routed = _served(jax_round, requests, **HEADS)
    paths["v5"] = routed.save(str(tmp / "v5.npz"))
    snap = {v: jax.tree.map(np.asarray, (s.service.state, s.service.heads))
            for v, s in (("v4", base), ("v5", routed))}
    return paths, snap


# ------------------------------------------------------------- store --


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": {"x": torch.randn((3, 4), generator=g),
                  "b16": torch.randn((2, 5), generator=g).to(torch.bfloat16)},
            "nt": _Pair(torch.arange(4, dtype=torch.int32),
                        np.asarray([True, False])),
            "seq": (np.arange(3.0), [torch.ones((2,), dtype=torch.bool)]),
            "none": None, "empty": {}, "n0": np.asarray(5, np.int64)}


def test_store_round_trip_without_ml_dtypes(tmp_path, monkeypatch):
    """Nested dicts, a NamedTuple, a tuple holding a list, None and an
    empty dict; a bf16 leaf comes back bit for bit with ml_dtypes
    unimportable, and the JAX package reads the same bits."""
    tree = _tree()
    path = store.save_pytree(str(tmp_path / "t"), tree, step=7)
    assert path.endswith("t.npz") and not Path(path + ".tmp.npz").exists()
    assert store.npz_keys(path) == {
        "a/x", "a/b16", "a/b16__dtype__", "nt/.p", "nt/.q", "seq/0",
        "seq/1/0", "n0", "__step__"}
    assert store.checkpoint_step(path) == 7
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    like = {"a": {"x": torch.zeros((3, 4)),
                  "b16": torch.zeros((2, 5), dtype=torch.bfloat16)},
            "nt": _Pair(torch.zeros(4, dtype=torch.int32),
                        np.zeros(2, bool)),
            "seq": (np.zeros(3), [torch.zeros((2,), dtype=torch.bool)]),
            "none": None, "empty": {}, "n0": np.zeros((), np.int64)}
    got = store.load_pytree(path, like)
    assert isinstance(got["nt"], _Pair) and isinstance(got["seq"][1], list)
    assert got["none"] is None and got["empty"] == {}
    for a, b in ((got["a"]["x"], tree["a"]["x"]),
                 (got["a"]["b16"], tree["a"]["b16"]),
                 (got["nt"].p, tree["nt"].p), (got["seq"][1][0],
                                               tree["seq"][1][0])):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(got["seq"][0], tree["seq"][0])
    assert int(got["n0"]) == 5
    monkeypatch.delitem(sys.modules, "ml_dtypes")
    jgot = jstore.load_pytree(path, {"a": {"b16": jnp.zeros(
        (2, 5), jnp.bfloat16)}})
    np.testing.assert_array_equal(
        np.asarray(jgot["a"]["b16"]).view(np.int16),
        tree["a"]["b16"].view(torch.int16).numpy())


def test_store_reads_jax_bf16_and_jax_key_paths(tmp_path, monkeypatch):
    """The JAX package's archive of the same tree has the same keys, and
    its bf16 leaf reads back in the port without ml_dtypes."""
    tree = _tree()
    jtree = jax.tree.map(lambda x: jnp.asarray(np.asarray(
        x.float() if isinstance(x, torch.Tensor) and
        x.dtype == torch.bfloat16 else x)), tree)
    jtree["a"]["b16"] = jtree["a"]["b16"].astype(jnp.bfloat16)
    jpath = jstore.save_pytree(str(tmp_path / "j.npz"), jtree, step=7)
    ppath = store.save_pytree(str(tmp_path / "p.npz"), tree, step=7)
    assert store.npz_keys(jpath) == store.npz_keys(ppath)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    got = store.load_pytree(jpath, {"a": {"b16": torch.zeros(
        (2, 5), dtype=torch.bfloat16)}})["a"]["b16"]
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(jtree["a"]["b16"]).view(np.int16))


def test_store_never_imports_ml_dtypes():
    src = (ROOT / "src/repro_torch/checkpoint/store.py").read_text()
    names = {a.name for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.ImportFrom)}
    assert not any("ml_dtypes" in str(n) for n in names)


@pytest.mark.parametrize("stored,want", [
    ("f64", torch.bfloat16), ("bf16", torch.float32), ("bf16", torch.int32),
    ("i64", torch.bfloat16), ("f64", torch.float32)])
def test_store_casts_as_jax_does(tmp_path, stored, want):
    """A cast between a native dtype and bf16 goes through f32."""
    vals = np.asarray([[1.00390625 + 2 ** -12, -3.5, 257.3],
                       [1e-3, 65504.0, -0.75]])
    leaf = {"f64": vals, "i64": np.round(vals * 7).astype(np.int64),
            "bf16": jnp.asarray(vals, jnp.bfloat16)}[stored]
    path = jstore.save_pytree(str(tmp_path / "c.npz"), {"v": leaf})
    got = store.load_pytree(path, {"v": torch.zeros((2, 3), dtype=want)})
    jwant = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
             torch.int32: jnp.int32}[want]
    ref = np.asarray(jstore.load_pytree(path, {"v": jnp.zeros(
        (2, 3), jwant)})["v"])
    if want == torch.bfloat16:
        np.testing.assert_array_equal(
            got["v"].view(torch.int16).numpy(), ref.view(np.int16))
    else:
        np.testing.assert_array_equal(got["v"].numpy(), ref)


def test_store_refuses_a_shape_mismatch(tmp_path):
    path = store.save_pytree(str(tmp_path / "s.npz"),
                             {"a": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="'a'"):
        store.load_pytree(path, {"a": torch.zeros((3, 2))})
    with pytest.raises(KeyError, match="'b'"):
        store.load_pytree(path, {"b": torch.zeros((2, 3))})


def test_tags_and_extras(tmp_path):
    tag = store.encode_tag("qwen1.5-0.5b|transformer")
    assert tag.dtype == np.uint8
    assert store.decode_tag(tag) == jstore.decode_tag(tag) == \
        "qwen1.5-0.5b|transformer"
    path = store.save_pytree(str(tmp_path / "e.npz"),
                             {"t": tag, "n": np.asarray(3)})
    ex = store.load_extras(path, ("t", "missing"))
    assert set(ex) == {"t"} and store.decode_tag(ex["t"]) == \
        "qwen1.5-0.5b|transformer"
    assert store.checkpoint_step(path) is None


# ------------------------------------------------------ serving state --


def _port_session(jax_round, **kw):
    opts = {**SERVE, **kw}
    jsess = japi.Session.from_round(_jplan(**kw), jax_round)
    heads = None
    if opts.get("heads", "off") != "off":
        heads = convert.heads(jax.tree.map(np.asarray, jsess.service.heads),
                              device="cpu")
    return Session.from_round(
        _plan(**kw), convert.round_result(jax.tree.map(np.asarray,
                                                       jax_round),
                                          device="cpu"),
        heads=heads, gumbel=JaxServeGumbel(0), device="cpu")


@pytest.mark.parametrize("heads", ["off", "on"])
def test_archive_keys_equal_jax(jax_round, requests, archives, tmp_path,
                                heads):
    """The port's archive of the serving state the JAX package's v4 (heads
    off) and v5 (heads on) archives hold has their key set, and the
    same arrays where the state is the same."""
    paths, _ = archives
    kw = HEADS if heads == "on" else {}
    sess = _port_session(jax_round, **kw)
    datas, kvs = requests
    (sess.serve_predict if kw else sess.serve)(datas[:5], kvs[:5])
    path = sess.save(str(tmp_path / "port"))
    jpath = paths["v5" if kw else "v4"]
    assert store.npz_keys(path) == store.npz_keys(jpath)
    with np.load(path) as a, np.load(jpath) as b:
        for key in ("counters", "tau_meta", "policy_id", "autoscale_id",
                    "autoscale_state", "autoscale_ladder", "drift_id",
                    "drift_state", "drift_mass", "server/.received",
                    "server/.mask", "server/.epoch", "heads_tag",
                    "heads_counters"):
            if key in b.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
                assert a[key].dtype == b[key].dtype, key


@pytest.mark.parametrize("schema", ["v1", "v2", "v3", "v4", "v5"])
def test_jax_archive_restores_in_port(jax_round, requests, archives,
                                      schema):
    """Restore the JAX package's archive in both packages: the same
    restored state bit for bit, then the same served labels, tau
    versions and counters (v5: clusters, routing, predictions and the
    routed counters too)."""
    paths, snap = archives
    datas, kvs = requests
    kw = HEADS if schema == "v5" else {}
    path = paths[schema]
    want_sess = japi.Session.restore(path, _jplan(**kw))
    got_sess = Session.restore(path, _plan(**kw), gumbel=JaxServeGumbel(0))
    svc, jsvc = got_sess.service, want_sess.service
    for a, b in zip(svc.state, jsvc.state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(svc._taubuf.bufs.numpy(),
                                  np.asarray(jsvc._taubuf.bufs))
    assert (svc._taubuf.active, svc.tau_version) == (
        jsvc._taubuf.active, jsvc.tau_version)
    np.testing.assert_array_equal(svc._counters(), jsvc._counters())
    if schema == "v4":
        for a, b in zip(svc.state, snap["v4"][0]):
            np.testing.assert_array_equal(a.numpy(), b)
    if kw:
        for name, leaf in jax.tree_util.tree_flatten_with_path(
                snap["v5"][1])[0]:
            keys = [p.key for p in name]
            got = svc.heads
            for k_ in keys:
                got = got[k_]
            np.testing.assert_array_equal(got.numpy(), leaf)
        got = got_sess.serve_predict(datas[5:], kvs[5:])
        want = want_sess.serve_predict(datas[5:], kvs[5:])
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.labels, np.asarray(w.labels),
                                          err_msg=f"request {i}")
            assert (g.tau_version, g.cluster, g.routed) == (
                w.tau_version, w.cluster, w.routed), i
        gp = np.stack([g.prediction for g in got])
        wp = np.stack([np.asarray(w.prediction) for w in want])
        assert np.abs(gp - wp).max() <= 1e-5 * np.abs(wp).max()
        assert got_sess.stats()["heads"] == want_sess.stats()["heads"]
    else:
        got = got_sess.serve_versioned(datas[5:], kvs[5:])
        want = want_sess.serve_versioned(datas[5:], kvs[5:])
        for i, ((g, gv), (w, wv)) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"request {i}")
            assert gv == wv, i
    st, jst = got_sess.stats(), want_sess.stats()
    for key in ("served_devices", "served_points", "folded",
                "since_refresh", "tau_version"):
        assert st[key] == jst[key], key
    assert got_sess.tau_version >= 1
    for a, b in zip(svc.state[1:], jsvc.state[1:]):   # after serving
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(svc.state.centers.numpy(),
                               np.asarray(jsvc.state.centers), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(
                                   jsvc.state.centers)).max())


@pytest.mark.parametrize("heads", ["off", "on"])
def test_port_archive_restores_in_jax(jax_round, requests, tmp_path, heads):
    """The port serves, saves; the JAX package restores the archive and
    serves the rest as the port does."""
    kw = HEADS if heads == "on" else {}
    datas, kvs = requests
    sess = _port_session(jax_round, **kw)
    if kw:
        sess.serve_predict(datas[:5], kvs[:5])
    else:
        sess.serve(datas[:5], kvs[:5])
    path = sess.save(str(tmp_path / "port.npz"))
    jsess = japi.Session.restore(path, _jplan(**kw))
    if kw:
        got = sess.serve_predict(datas[5:], kvs[5:])
        want = jsess.serve_predict(datas[5:], kvs[5:])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.labels, np.asarray(w.labels))
            assert (g.tau_version, g.cluster, g.routed) == (
                w.tau_version, w.cluster, w.routed)
        assert sess.stats()["heads"] == jsess.stats()["heads"]
    else:
        got = sess.serve_versioned(datas[5:], kvs[5:])
        want = jsess.serve_versioned(datas[5:], kvs[5:])
        for (g, gv), (w, wv) in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert gv == wv
    assert sess.stats()["served_devices"] == jsess.stats()[
        "served_devices"] == 10


def test_port_restore_replays_itself(jax_round, requests, tmp_path):
    """Save between two halves of the traffic and restore (base seed
    from the archive, no gumbel given): the same labels, versions and
    fold state, bit for bit, as the uninterrupted port session."""
    datas, kvs = requests
    plan = _plan(checkpoint=str(tmp_path / "plan_ck"))
    rr = convert.round_result(jax.tree.map(np.asarray, jax_round),
                              device="cpu")
    live = Session.from_round(plan, rr, seed=3, device="cpu")
    live.serve_versioned(datas[:6], kvs[:6])
    path = live.save()                        # plan.checkpoint
    assert path == str(tmp_path / "plan_ck.npz")
    restored = Session.restore(path, plan)
    want = live.serve_versioned(datas[6:], kvs[6:])
    got = restored.serve_versioned(datas[6:], kvs[6:])
    assert restored.tau_version == live.tau_version == 2  # one refresh on
    for (g, gv), (w, wv) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert gv == wv
    for a, b in zip(restored.service.state, live.service.state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(restored.tau_centers, live.tau_centers,
                               rtol=0, atol=0)
    with pytest.raises(SessionError, match="path"):
        Session.from_round(_plan(), rr, device="cpu").save()


@pytest.mark.parametrize("writer,field", [
    (dict(fold_policy="lru"), "fold_policy"),
    (dict(autoscale="latency"), "autoscale"),
    (dict(autoscale="throughput"), "autoscale"),
    (dict(encoder="granite-3-2b"), "encoder"),
])
def test_restore_refuses_unported_modes(jax_round, tmp_path, writer, field):
    """An archive the JAX package wrote under a mode the restoring plan
    (drop, autoscale off) does not run is refused with the field named:
    the encoder, which the port does not have, and lru, latency and
    throughput, which it runs but this plan does not."""
    path = japi.Session.from_round(_jplan(**writer), jax_round).save(
        str(tmp_path / "m.npz"))
    with pytest.raises(StreamConfigError, match=f"StreamConfig.{field}"):
        Session.restore(path, _plan())


@pytest.mark.parametrize("writer", [
    dict(drift="decay", drift_half_life=64),
    dict(drift="split_merge", drift_half_life=64)],
    ids=["decay", "split_merge"])
def test_restore_takes_jax_drift_archives(jax_round, requests, tmp_path,
                                         writer):
    """An archive the JAX package wrote under decay or split_merge (once
    refused by name) restores in the port under the same drift plan,
    with its fold epochs, mass and counters, and both serve the same
    labels, tau versions and drift counters; under drift off it is
    refused, naming StreamConfig.drift."""
    datas, kvs = requests
    jsess = japi.Session.from_round(_jplan(**writer), jax_round)
    jsess.serve(datas[:5], kvs[:5])
    path = jsess.save(str(tmp_path / "m.npz"))
    with pytest.raises(StreamConfigError, match="StreamConfig.drift"):
        Session.restore(path, _plan())
    sess = Session.restore(path, _plan(**writer), gumbel=JaxServeGumbel(0))
    svc, jsvc = sess.service, jsess.service
    for a, b in zip(svc.state, jsvc.state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(svc._drift_mass, jsvc._drift_mass)
    got = sess.serve_versioned(datas[5:], kvs[5:])
    want = jsess.serve_versioned(datas[5:], kvs[5:])
    for (g, gv), (w, wv) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert gv == wv
    assert sess.tau_version == jsess.tau_version >= 2
    st, jst = sess.stats()["drift"], jsess.stats()["drift"]
    assert (st["mode"], st["events"], st["moves"]) == (
        jst["mode"], jst["events"], jst["moves"])
    np.testing.assert_allclose(st["mass"], jst["mass"], rtol=1e-5)


@pytest.mark.parametrize("writer,reader,field", [
    (dict(fold_policy="lru"), dict(), "fold_policy"),
    (dict(autoscale="latency"), dict(autoscale="throughput"), "autoscale"),
    (dict(autoscale="throughput"), dict(autoscale="latency"), "autoscale"),
    (dict(fold_policy="weighted_reservoir"), dict(fold_policy="lru"),
     "fold_policy"),
])
def test_restore_refuses_a_mode_mismatch(jax_round, tmp_path, writer,
                                         reader, field):
    """An archive written under one policy or autoscale mode restores only
    under the same: the slots and the decision state mean nothing under
    another. The error names the field and the archive's value."""
    path = japi.Session.from_round(_jplan(**writer), jax_round).save(
        str(tmp_path / "m.npz"))
    with pytest.raises(StreamConfigError,
                       match=f"StreamConfig.{field}=.*saved under "
                             f"{field}='{writer[field]}'"):
        Session.restore(path, _plan(**reader))


def _v3_under_latency(archives, tmp_path):
    """The v3 archive (no drift arrays) with its autoscale id set to
    latency: a v3 archive written under autoscale latency."""
    paths, _ = archives
    with np.load(paths["v3"]) as data:
        arrays = dict(data)
    arrays["autoscale_id"] = np.asarray(JAX_AUTOSCALE_IDS["latency"],
                                        np.int64)
    np.savez(tmp_path / "v3l.npz", **arrays)
    return str(tmp_path / "v3l.npz")


def test_restore_refuses_a_v3_archive_under_latency(archives, tmp_path):
    """A v3 archive written under autoscale latency, restored under a
    plan with autoscale off or throughput."""
    path = _v3_under_latency(archives, tmp_path)
    for autoscale in ("off", "throughput"):
        with pytest.raises(StreamConfigError, match="autoscale='latency'"):
            Session.restore(path, _plan(autoscale=autoscale))


def test_v3_archive_under_latency_restores_and_replays(archives, requests,
                                                       tmp_path):
    """The same archive under a latency plan restores in both packages,
    which then serve the rest alike: labels, versions and decisions."""
    path = _v3_under_latency(archives, tmp_path)
    datas, kvs = requests
    got_sess = Session.restore(path, _plan(autoscale="latency"),
                               gumbel=JaxServeGumbel(0))
    want_sess = japi.Session.restore(path, _jplan(autoscale="latency"))
    for lo, hi in ((5, 6), (6, 10)):
        got = got_sess.serve_versioned(datas[lo:hi], kvs[lo:hi])
        want = want_sess.serve_versioned(datas[lo:hi], kvs[lo:hi])
        for (g, gv), (w, wv) in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert gv == wv
        assert (got_sess.service.autoscaler.decision
                == want_sess.service.autoscaler.decision)
    assert got_sess.stats()["autoscale"]["decisions"] == 2


@pytest.mark.parametrize("plan_kw", [
    dict(), dict(heads="linear"), dict(heads="qwen1.5-0.5b",
                                       head_arch="ffn")])
def test_restore_refuses_a_heads_mismatch(archives, plan_kw):
    paths, _ = archives
    with pytest.raises(StreamConfigError, match="StreamConfig.heads"):
        Session.restore(paths["v5"], _plan(**plan_kw))


def test_pre_v5_archive_restores_with_seeded_heads(archives, requests):
    """A v4 archive under heads on: labels as a heads-off restore's, the
    heads drawn from the archive's base seed (the same twice)."""
    paths, _ = archives
    datas, kvs = requests
    plain = Session.restore(paths["v4"], _plan(), gumbel=JaxServeGumbel(0))
    a = Session.restore(paths["v4"], _plan(heads="linear"),
                        gumbel=JaxServeGumbel(0))
    b = Session.restore(paths["v4"], _plan(heads="linear"))
    want = plain.serve_versioned(datas[5:], kvs[5:])
    got = a.serve_predict(datas[5:], kvs[5:])
    for g, (w, wv) in zip(got, want):
        np.testing.assert_array_equal(g.labels, w)
        assert g.tau_version == wv
    for x, y in zip(jax.tree.leaves(a.service.heads),
                    jax.tree.leaves(b.service.heads)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_ids_are_the_jax_packages():
    assert policy.POLICY_IDS == JAX_POLICY_IDS
    assert stream.AUTOSCALE_IDS == JAX_AUTOSCALE_IDS
    assert stream.DRIFT_IDS == JAX_DRIFT_IDS
