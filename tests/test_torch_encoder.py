"""The latent-space ingestion encoder of the port (models/encoder.py, the
plane's encoded steps, fed/stream.py's raw-sequence serving and schema
v6 archives) against the JAX package's, on seeded numpy inputs, with the
JAX encoder's parameters carried over by ``convert.encoder`` and the JAX
package's k-means++ draws (test_torch_prng.JaxServeGumbel).

Tolerances: encoder outputs in f32 within rtol 1e-5 / atol 1e-5; with
bf16 storage within 1e-2 * max(max|y|, 1) (an f32 sum that rounds to the
other side of a bf16 step moves an activation by one bf16 ulp, 2^-8
relative, and the step propagates). Exact: labels, tau versions,
encoder stats and plane compile counts; the fold state after serving
within 1e-4 of its largest entry where it holds embeddings (products
summed in another order), exactly elsewhere.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import api as japi  # noqa: E402
from repro.models import encoder as jenc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.fed.api import FederationPlan, PlanError, Session  # noqa: E402
from repro_torch.fed.plane import ServePlane  # noqa: E402
from repro_torch.fed.stream import StreamConfig, StreamConfigError  # noqa: E402
from repro_torch.models import encoder as enc  # noqa: E402
from test_torch_prng import JaxServeGumbel  # noqa: E402

# tests/test_encode_serve.py's plan and traffic.
K, KP, D = 8, 3, 16
ENC = "qwen1.5-0.5b"
SEQ = 16
PLAN = dict(k=K, k_prime=KP, d=D, capacity=128, batch_size=2,
            bucket_sizes=(16, 32), encoder=ENC, encode_seq_len=SEQ)


def _tau(seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.normal(size=(K, D)) * 4, np.float32)


def _token_requests(count, seed, n_range=(4, 14), s_range=(2, SEQ)):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(count):
        n = int(rng.integers(*n_range))
        s = int(rng.integers(s_range[0], s_range[1] + 1))
        reqs.append(np.asarray(rng.normal(size=(n, s, D)), np.float32))
    return reqs


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, dtype):
    want = np.asarray(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        bound = 1e-2 * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=bound)


# -------------------------------------------------------------- specs --


@pytest.mark.parametrize("name", list_archs())
def test_spec_and_param_count_match_jax(name):
    """resolve_encoder_spec at several d: the same spec, or the same
    named error where the config's heads do not divide d; the same
    parameter count."""
    for d in (8, 12, 16, 20, 24, 32, 48, 300):
        try:
            want = jenc.resolve_encoder_spec(name, d)
        except jenc.EncoderConfigError as e:
            with pytest.raises(enc.EncoderConfigError) as got:
                enc.resolve_encoder_spec(name, d)
            assert str(got.value) == str(e)
            continue
        spec = enc.resolve_encoder_spec(name, d)
        assert tuple(spec) == tuple(want), (name, d)
        assert spec.n_layers <= 2
        assert enc.encoder_param_count(spec) == \
            jenc.encoder_param_count(want)


@pytest.mark.parametrize("name,d,match", [
    ("no-such-config", 16, r"encoder='no-such-config' is invalid: accepted "
                           r"values are 'off' or a registered model config"),
    ("granite-3-2b", 20, r"encoder='granite-3-2b' is invalid for d=20: the "
                         r"config's n_heads=8 must divide"),
    ("nemotron-4-15b", 16, r"n_heads=6 must divide")])
def test_spec_named_errors(name, d, match):
    with pytest.raises(enc.EncoderConfigError, match=match) as got:
        enc.resolve_encoder_spec(name, d)
    with pytest.raises(jenc.EncoderConfigError) as want:
        jenc.resolve_encoder_spec(name, d)
    assert str(got.value) == str(want.value)
    if name == "no-such-config":
        assert str(list_archs()) in str(got.value)


def test_init_encoder_has_the_v6_layout():
    """The port's init: the JAX tree's keys and leaf shapes (layers
    stacked on a leading axis, then norm_f), RMSNorm ones even for a
    layernorm config, the same draws from the same generator seed."""
    for name, d in (("qwen1.5-0.5b", 16), ("nemotron-4-15b", 24)):
        spec = enc.resolve_encoder_spec(name, d)
        got = enc.init_encoder(torch.Generator().manual_seed(4), spec,
                               device="cpu")
        want = jenc.init_encoder(jax.random.PRNGKey(0),
                                 jenc.resolve_encoder_spec(name, d))
        flat_g = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), got))[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (_, a), (_, b) in zip(flat_g, flat_w):
            assert a.shape == b.shape and a.dtype == np.float32
        assert set(got["layers"]["norm1"]) == {"w"}
        assert torch.equal(got["norm_f"]["w"], torch.ones(d))
        again = enc.init_encoder(torch.Generator().manual_seed(4), spec,
                                 device="cpu")
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                      got)),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                      again))):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ forward --


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,d", [
    ("qwen1.5-0.5b", 16),       # SwiGLU, 4 heads
    ("granite-3-2b", 32),       # GQA, 8 heads over 2
    ("whisper-base", 16),       # gelu, layernorm config
    ("nemotron-4-15b", 24)])    # relu2, 6 heads over 2
def test_apply_encoder_matches_jax(name, d, dtype):
    """apply_encoder on ragged token masks, one item with no valid token
    (its embedding exactly 0 in both) and weights scaled x5 so that the
    attention and FFN move the states."""
    spec = enc.resolve_encoder_spec(name, d)
    jspec = jenc.resolve_encoder_spec(name, d)
    jp = jax.tree.map(lambda a: a * 5.0,
                      jenc.init_encoder(jax.random.PRNGKey(3), jspec))
    params = convert.encoder(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(d)
    x = rng.normal(size=(3, 5, 12, d)).astype(np.float32)
    m = rng.random((3, 5, 12)) < 0.6
    m[0, 0] = False
    m[1, 2, :] = False
    m[2, 4, :] = True
    want = np.asarray(jenc.apply_encoder(jp, jnp.asarray(x), jnp.asarray(m),
                                         jspec, dtype))
    got = enc.apply_encoder(params, torch.from_numpy(x),
                            torch.from_numpy(m), spec, dtype)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5, d)
    got = got.numpy()
    assert np.all(np.isfinite(got))
    for i, j in ((0, 0), (1, 2)):
        assert not got[i, j].any() and not want[i, j].any()
    _close(got, want, dtype)


def test_encoded_step_is_the_step_on_the_embeddings():
    """The plane's encode step is apply_encoder then the unchanged serve
    step: the same labels and reports, bit for bit."""
    from repro_torch.fed.plane import _make_encode_step, _make_step
    from repro_torch.utils.prng import GumbelSource
    cfg = StreamConfig(**PLAN)
    spec = cfg.encoder_spec()
    params = enc.init_encoder(torch.Generator().manual_seed(1), spec,
                              device="cpu")
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(2, 16, 8, D)), dtype=torch.float32)
    tm = torch.as_tensor(rng.random((2, 16, 8)) < 0.7)
    pm = torch.as_tensor(rng.random((2, 16)) < 0.8)
    kv = torch.full((2,), KP, dtype=torch.int32)
    g = GumbelSource(0).draw([0, 1], KP, 16, "cpu")
    tau = torch.as_tensor(_tau())
    got = _make_encode_step(cfg)(tau, params, g, x, pm, kv, tm)
    emb = enc.apply_encoder(params, x, tm, spec)
    want = _make_step(cfg)(tau, g, emb, pm, kv)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_encoder_off_builds_nothing_new():
    cfg = StreamConfig(**{**PLAN, "encoder": "off"})
    plane = ServePlane(cfg, "cpu")
    assert plane._encode is None and plane._enc_routed is None
    assert cfg.encoder_spec() is None


# ------------------------------------------------------------ serving --


def _sessions(plan_kw, tau=None, **jkw):
    """The JAX session and the port's, the port fed JAX's encoder, heads
    and draws."""
    tau = _tau() if tau is None else tau
    jsess = japi.Session.from_tau(japi.FederationPlan(**plan_kw), tau,
                                  **jkw)
    svc = jsess.service
    heads = (None if svc.heads is None
             else convert.heads(_np_tree(svc.heads), device="cpu"))
    sess = Session.from_tau(
        FederationPlan(**plan_kw, device="cpu"), tau, gumbel=JaxServeGumbel(0),
        encoder=convert.encoder(_np_tree(svc.encoder), device="cpu"),
        heads=heads)
    return sess, jsess


def _same_state(sess, jsess):
    svc, jsvc = sess.service, jsess.service
    for a, b in zip(svc.state[1:], jsvc.state[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jsvc.state.centers)
    np.testing.assert_allclose(svc.state.centers.numpy(), want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30))


def _same_stats(sess, jsess):
    st, jst = sess.stats(), jsess.stats()
    assert st["encoder"] == jst["encoder"]
    for key in ("served_devices", "served_points", "folded", "tau_version",
                "since_refresh", "plane_compiles"):
        assert st[key] == jst[key], key


@pytest.mark.filterwarnings("ignore:Session streaming is seeded")
@pytest.mark.parametrize("opts", [
    dict(), dict(encode_dtype="bf16"),
    dict(refresh_every=4, refresh="async"),
    dict(drift="split_merge", drift_half_life=8, refresh_every=4,
         drift_retire_frac=0.2, autoscale="latency", batch_size=4)],
    ids=["f32", "bf16", "async_refresh", "split_merge_latency"])
def test_encoded_session_matches_jax(opts):
    """test_encode_serve.py's streams in both packages: labels, tau
    versions, fold state, encoder stats and plane compile counts."""
    kw = {**PLAN, **opts}
    sess, jsess = _sessions(kw)
    reqs = _token_requests(7, seed=1) + _token_requests(
        9, seed=2, s_range=(1, SEQ))
    for lo, hi in ((0, 7), (7, 10), (10, 16)):
        got = sess.serve_versioned(reqs[lo:hi])
        want = jsess.serve_versioned(reqs[lo:hi])
        for i, ((g, gv), (w, wv)) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"request {lo + i}")
            assert gv == wv, lo + i
            assert g.dtype == np.int32 and g.shape == (reqs[lo + i].shape[0],)
    _same_state(sess, jsess)
    _same_stats(sess, jsess)
    st = sess.stats()["encoder"]
    assert st["mode"] == ENC and st["seq_len"] == SEQ
    assert st["encoded_points"] == sum(r.shape[0] for r in reqs)
    if opts.get("drift"):
        assert sess.stats()["drift"]["moves"] == jsess.stats()["drift"][
            "moves"]
        for key in ("shards", "batch_size", "ladder", "decisions"):
            assert sess.stats()["autoscale"][key] == jsess.stats()[
                "autoscale"][key], key


def test_encoder_with_routed_heads_matches_jax():
    """The encoded routed step (granite-3-2b encoder, GQA; transformer
    heads): labels, versions, clusters and routing exact, predictions
    within 1e-5 of their largest magnitude, and the labels those of the
    heads-off encoded session."""
    kw = {**PLAN, "d": 32, "encoder": "granite-3-2b", "heads": "linear",
          "head_capacity": 0.5, "batch_size": 4}
    tau = np.asarray(np.random.default_rng(0).normal(size=(K, 32)) * 4,
                     np.float32)
    sess, jsess = _sessions(kw, tau=tau)
    rng = np.random.default_rng(15)
    reqs = [np.asarray(rng.normal(size=(int(rng.integers(4, 14)),
                                        int(rng.integers(2, SEQ + 1)), 32)),
                       np.float32) for _ in range(9)]
    got = sess.serve_predict(reqs)
    want = jsess.serve_predict(reqs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.labels, np.asarray(w.labels),
                                      err_msg=f"request {i}")
        assert (g.tau_version, g.cluster, g.routed) == (
            w.tau_version, w.cluster, w.routed), i
    gp = np.stack([g.prediction for g in got])
    wp = np.stack([np.asarray(w.prediction) for w in want])
    assert np.abs(gp - wp).max() <= 1e-5 * np.abs(wp).max()
    assert sum(g.routed for g in got) and not all(g.routed for g in got)
    assert sess.stats()["heads"] == jsess.stats()["heads"]
    _same_stats(sess, jsess)
    off, _ = _sessions({**kw, "heads": "off"}, tau=tau)
    for g, lbl in zip(got, off.serve(reqs)):
        np.testing.assert_array_equal(g.labels, lbl)


def test_bucketing_over_n_and_seq_bounds_compiles():
    """Requests group by (n_pad, seq_rung) as in the JAX package; a
    same-rung shape adds no step signature, a new rung one."""
    sess, _ = _sessions(PLAN)
    svc = sess.service
    rng = np.random.default_rng(3)

    def req(n, s):
        return np.asarray(rng.normal(size=(n, s, D)), np.float32)

    lad = tuple(PLAN["bucket_sizes"])
    assert svc._bucket_key(req(5, 5), lad) == (16, 8)
    assert svc._bucket_key(req(7, 8), lad) == (16, 8)
    assert svc._bucket_key(req(5, 9), lad) == (16, 16)
    assert svc._bucket_key(req(20, 3), lad) == (32, 8)
    sess.serve([req(5, 5), req(7, 8)])
    c1 = svc.plane.compile_count
    sess.serve([req(6, 6), req(4, 7)])
    assert svc.plane.compile_count == c1
    sess.serve([req(5, 12)])
    assert svc.plane.compile_count == c1 + 1
    off = Session.from_tau(FederationPlan(**{**PLAN, "encoder": "off"},
                                          device="cpu"), _tau())
    assert off.service._bucket_key(req(5, 5)[:, 0], lad) == 16


def test_submit_rejects_overlong_empty_and_flat_requests():
    sess, _ = _sessions(PLAN)
    rng = np.random.default_rng(5)
    for s in (SEQ + 1, 0):
        with pytest.raises(StreamConfigError, match="encode_seq_len"):
            sess.submit(np.asarray(rng.normal(size=(4, s, D)), np.float32))
    with pytest.raises(StreamConfigError, match=r"\(n, seq, d=16\)"):
        sess.submit(np.zeros((4, D), np.float32))


@pytest.mark.parametrize("field,value", [
    ("encoder", "not-a-config"), ("encode_dtype", "f16"),
    ("encode_seq_len", 0)])
def test_plan_validation_named_errors(field, value):
    with pytest.raises(PlanError, match=f"FederationPlan.{field}"):
        FederationPlan(**{**PLAN, field: value}, device="cpu")
    with pytest.raises(japi.PlanError, match=f"FederationPlan.{field}"):
        japi.FederationPlan(**{**PLAN, field: value})


# ----------------------------------------------------------- archives --


@pytest.mark.filterwarnings("ignore:Session streaming is seeded")
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_v6_archive_replays_in_port(tmp_path, dtype):
    """The JAX package serves, saves (schema v6); the port restores it
    with the same encoder bits and counters and serves the rest as the
    JAX package does."""
    plan_kw = {**PLAN, "encode_dtype": dtype, "refresh_every": 5}
    jsess = japi.Session.from_tau(japi.FederationPlan(**plan_kw), _tau())
    reqs = _token_requests(9, seed=7)
    jsess.serve(reqs[:5])
    path = jsess.save(str(tmp_path / "jax_v6.npz"))
    sess = Session.restore(path, FederationPlan(**plan_kw, device="cpu"),
                           gumbel=JaxServeGumbel(0))
    want_leaves = jax.tree_util.tree_flatten_with_path(
        _np_tree(jsess.service.encoder))[0]
    got = sess.service.encoder
    for path_, leaf in want_leaves:
        node = got
        for p in path_:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert sess.stats()["encoder"] == jsess.stats()["encoder"]
    g = sess.serve_versioned(reqs[5:])
    w = jsess.serve_versioned(reqs[5:])
    for (a, av), (b, bv) in zip(g, w):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert av == bv
    assert sess.tau_version == jsess.tau_version >= 1
    _same_state(sess, jsess)
    _same_stats(sess, jsess)


@pytest.mark.filterwarnings("ignore:Session streaming is seeded")
def test_port_v6_archive_restores_in_jax(tmp_path):
    """The port serves, saves; the JAX package restores the archive and
    serves the rest as the port does."""
    sess, _ = _sessions({**PLAN, "refresh_every": 5})
    reqs = _token_requests(9, seed=8)
    sess.serve(reqs[:5])
    path = sess.save(str(tmp_path / "port_v6.npz"))
    jsess = japi.Session.restore(path, japi.FederationPlan(
        **PLAN, refresh_every=5))
    g = sess.serve_versioned(reqs[5:])
    w = jsess.serve_versioned(reqs[5:])
    for (a, av), (b, bv) in zip(g, w):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert av == bv
    _same_stats(sess, jsess)


@pytest.mark.parametrize("reader,match", [
    (dict(encode_seq_len=32), "encode_seq_len=32"),
    (dict(encode_dtype="bf16"), "encode_dtype='bf16'"),
    (dict(encoder="granite-3-2b"), "encoder='granite-3-2b'"),
    (dict(encoder="off"), "encoder='off'")])
def test_v6_tag_mismatch_refuses(tmp_path, reader, match):
    """A v6 archive restores only under its own encoder, dtype and
    ceiling; the refusal names the plan's fields and the archive's."""
    jsess = japi.Session.from_tau(japi.FederationPlan(**PLAN), _tau())
    jsess.serve(_token_requests(2, seed=9))
    path = jsess.save(str(tmp_path / "tag.npz"))
    with pytest.raises(StreamConfigError, match=match) as e:
        Session.restore(path, FederationPlan(**{**PLAN, **reader},
                                             device="cpu"))
    assert "StreamConfig.encoder=" in str(e.value)
    assert "saved under encoder='qwen1.5-0.5b'/encode_dtype='f32'/" \
        "encode_seq_len=16" in str(e.value)


def test_pre_v6_archive_restores_a_fresh_deterministic_encoder(tmp_path):
    """A JAX archive written with the encoder off restores under an
    encoder-on plan: tau and the fold state load, and the encoder is
    drawn from the archive's seed, the same bits twice, so two restores
    serve alike. (It cannot equal the JAX package's re-init: that one
    draws with threefry, the port with its own generator.)"""
    old = japi.Session.from_tau(japi.FederationPlan(k=K, k_prime=KP, d=D,
                                                    capacity=128), _tau())
    rng = np.random.default_rng(11)
    old.serve([np.asarray(rng.normal(size=(6, D)), np.float32)])
    path = old.save(str(tmp_path / "pre_v6.npz"))
    ra = Session.restore(path, FederationPlan(**PLAN, device="cpu"))
    rb = Session.restore(path, FederationPlan(**PLAN, device="cpu"))
    np.testing.assert_array_equal(ra.tau_centers.numpy(),
                                  np.asarray(old.tau_centers))
    assert ra.stats()["encoder"]["encoded_points"] == 0
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 ra.service.encoder)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 rb.service.encoder))):
        np.testing.assert_array_equal(a, b)
    fresh = Session.from_tau(FederationPlan(**PLAN, device="cpu"), _tau())
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 ra.service.encoder)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 fresh.service.encoder))):
        np.testing.assert_array_equal(a, b)
    reqs = _token_requests(3, seed=13)
    for a, b in zip(ra.serve(reqs), rb.serve(reqs)):
        np.testing.assert_array_equal(a, b)


def test_port_v6_round_trip_bitwise(tmp_path):
    """Restore then serve in the port equals the uninterrupted port
    session bit for bit (bf16 storage), with the encoder leaves and
    counters carried."""
    plan = FederationPlan(**PLAN, encode_dtype="bf16", device="cpu")
    live = Session.from_tau(plan, _tau(), seed=4)
    reqs = _token_requests(5, seed=7)
    live.serve(reqs[:3])
    path = live.save(str(tmp_path / "v6.npz"))
    replica = Session.restore(path, plan)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 live.service.encoder)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 replica.service.encoder))):
        np.testing.assert_array_equal(a, b)
    assert replica.stats()["encoder"] == live.stats()["encoder"]
    for (a, av), (b, bv) in zip(live.serve_versioned(reqs[3:]),
                                replica.serve_versioned(reqs[3:])):
        np.testing.assert_array_equal(a, b)
        assert av == bv
