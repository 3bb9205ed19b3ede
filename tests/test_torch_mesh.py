"""The replicated and sharded topologies and the sharded serve plane of
the port, in gloo worlds of 1, 2 and 4 ranks on the CPU.

Each world is one ``torch.multiprocessing.spawn`` whose ranks run every
case of that world (``_torch_mesh_ranks``) on the same numpy inputs and
the JAX package's k-means++ draws, computed here. The rule across
topologies is the JAX package's (DESIGN.md §4): the round's labels equal
the simulated round's exactly, tau within 1e-4 of its largest entry; the
sharded plane equals the single-device plane bit for bit (labels, tau
versions, fold state; routed: predictions, clusters and routing; drift:
mass, counters and the re-mapped heads), and every rank holds the same
bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_mesh_ranks as R  # noqa: E402
from repro.fed import api as japi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import server as S  # noqa: E402
from repro_torch.data.gaussian import (late_device_stream,  # noqa: E402
                                       structured_devices)
from repro_torch.fed.api import FederationPlan, PlanError, Session  # noqa: E402
from test_torch_prng import (JaxKeyGumbel, JaxRoundGumbel,  # noqa: E402
                             JaxServeGumbel)
from test_torch_session import _tau_close  # noqa: E402

# tests/test_api.py's CHILD round and tests/test_plane.py's PLANE_CHILD.
K, KP, D = 16, 4, 24
ABSENT = (3, 12)
PLANE = dict(k=K, k_prime=KP, d=D, capacity=256, batch_size=8,
             bucket_sizes=(32, 64, 128), refresh_every=5, refresh="async")
AUTOSCALE = dict(PLANE, autoscale="latency")
BURSTS = (1, 3, 8, 2, 5, 1, 4)
LLOYD_K, LLOYD_ITERS = 16, 10
# The routed plane: heads on, half the default queue depth, so that
# C = 1 slot a cluster for a batch of 8 and queues overflow across
# shards. The drift plane: tests/test_drift.py:345's split_merge plan.
ROUTED = dict(PLANE, heads="linear", head_capacity=0.5)
DRIFT = dict(k=K, k_prime=KP, d=D, capacity=512, batch_size=8,
             bucket_sizes=(32, 64, 128), refresh_every=4,
             drift="split_merge", drift_half_life=24, drift_retire_frac=0.2)
WORLDS = (1, 2, 4)
TOPOLOGIES = ("replicated", "sharded")


# ------------------------------------------------------------ inputs --


@pytest.fixture(scope="module")
def mixture():
    return structured_devices(0, k=K, d=D, k_prime=KP, m0=4,
                              n_per_comp_dev=20, sep=60.0)


@pytest.fixture(scope="module")
def part(mixture):
    p = np.ones(mixture.data.shape[0], bool)
    p[list(ABSENT)] = False
    return p


@pytest.fixture(scope="module")
def jax_rounds(mixture, part):
    """The JAX package's simulated round of every variant."""
    out = {}
    for pname, p in (("all", None), ("absent", part)):
        for weighted in (False, True):
            plan = japi.FederationPlan(k=K, k_prime=KP, d=D,
                                       weight_by_core_counts=weighted)
            r = japi.Session(plan).run(
                jax.random.PRNGKey(1), jnp.asarray(mixture.data),
                participation=None if p is None else jnp.asarray(p))
            out[(pname, weighted)] = (np.asarray(r.labels),
                                      np.asarray(r.tau_centers))
    return out


def _round_draws(data):
    Z, n, _ = data.shape
    g = JaxRoundGumbel(jax.random.PRNGKey(1), Z).draw(range(Z), KP, n,
                                                     "cpu").numpy()
    return {(z, n): g[z] for z in range(Z)}


@pytest.fixture(scope="module")
def plane_inputs():
    """PLANE_CHILD's round (computed by the JAX package, carried over by
    convert), its late devices and the JAX serving draws."""
    fm = structured_devices(0, k=K, d=D, k_prime=KP, m0=4,
                            n_per_comp_dev=25, sep=60.0)
    jr = japi.Session(japi.FederationPlan(k=K, k_prime=KP, d=D)).run(
        jax.random.PRNGKey(1), jnp.asarray(fm.data)).detail
    rr = convert.round_result(jax.tree.map(np.asarray, jr), device="cpu")
    stream = late_device_stream(fm.means, KP, 13, 5, n_range=(10, 120))
    reqs, kvs = [r[0] for r in stream], [r[2] for r in stream]
    Z = fm.data.shape[0]
    src = JaxServeGumbel(0)
    draws = {(rid, n): src.draw([rid], KP, n, "cpu").numpy()[0]
             for rid in range(Z, Z + len(reqs) + 4) for n in (32, 64, 128)}
    return dict(fm=fm, jax_round=jr, round=rr, reqs=reqs, kvs=kvs,
                draws=draws)


@pytest.fixture(scope="module")
def single_plane(plane_inputs):
    """The port's single-device plane and the JAX package's single-host
    plane on PLANE_CHILD's traffic."""
    pi = plane_inputs
    sess = Session.from_round(FederationPlan(**PLANE, device="cpu"),
                              pi["round"], gumbel=R.TableGumbel(pi["draws"]))
    port = R.served_pair(sess, pi["reqs"], pi["kvs"])
    jsess = japi.Session.from_round(japi.FederationPlan(**PLANE),
                                    pi["jax_round"])
    want = R.served_pair(jsess, pi["reqs"], pi["kvs"])
    return dict(served=port, state=[t.numpy() for t in sess.service.state],
                version=sess.tau_version, jax=want)


@pytest.fixture(scope="module")
def shifted():
    """24 requests from resampled means (x40): split/retire moves
    centers on this stream, and its clusters collide in batches."""
    means = np.random.default_rng(3).normal(size=(K, D)).astype(
        np.float32) * 40.0
    stream = late_device_stream(means, KP, 24, 19, n_range=(15, 50))
    return [r[0] for r in stream], [r[2] for r in stream]


def _routed_spec(pi, shifted, bursts=None):
    reqs, kvs = shifted
    return dict(plan=ROUTED, round=pi["round"], reqs=reqs, kvs=kvs,
                chunk=ROUTED["batch_size"], bursts=bursts)


@pytest.fixture(scope="module")
def single_routed(plane_inputs, shifted):
    """The single-device port under the routed and drift plans: what
    the sharded ranks must equal."""
    spec = _routed_spec(plane_inputs, shifted, BURSTS)
    plan = FederationPlan(**ROUTED, device="cpu")
    rr = plane_inputs["round"]
    sess = Session.from_round(plan, rr, seed=3)
    out = {"served": R.served_routed(sess, spec["reqs"], spec["kvs"], 8),
           "state": [t.numpy() for t in sess.service.state],
           "heads": sess.stats()["heads"]}
    auto = Session.from_round(plan.with_options(autoscale="latency"), rr,
                              seed=3)
    served, at = [], 0
    for nb in BURSTS:
        served += R.served_routed(auto, spec["reqs"][at:at + nb],
                                  spec["kvs"][at:at + nb], nb)
        at += nb
    out["auto"] = {"served": served,
                   "state": [t.numpy() for t in auto.service.state]}
    drift = {}
    for heads in ("off", "linear"):
        d = Session.from_round(FederationPlan(**DRIFT, heads=heads,
                                              device="cpu"), rr, seed=3)
        reqs, kvs = shifted
        if heads == "off":
            served = [d.serve_versioned(reqs[lo:lo + 8], kvs[lo:lo + 8])
                      for lo in range(0, len(reqs), 8)]
        else:
            served = R.served_routed(d, reqs, kvs, 8)
        drift[heads] = {"served": served, **R.drift_outcome(d)}
    out["drift"] = drift
    return out


def _burst_stream(fm):
    stream = late_device_stream(fm.means, KP, sum(BURSTS), 9,
                                n_range=(10, 120))
    return [r[0] for r in stream], [r[2] for r in stream]


@pytest.fixture(scope="module")
def lloyd_inputs(mixture):
    data = mixture.data
    N = data.shape[0] * data.shape[1]
    n_sub = len(range(0, N, max(1, N // (64 * LLOYD_K)))[:64 * LLOYD_K])
    key = jax.random.PRNGKey(2)
    g = JaxKeyGumbel(key).draw([0], LLOYD_K, n_sub, "cpu").numpy()[0]
    return dict(data=data, k=LLOYD_K, iters=LLOYD_ITERS,
                draws={(0, n_sub): g}, key=key)


def _primitive_inputs(world):
    rng = np.random.default_rng(world)
    return dict(
        psum=rng.normal(size=(world, 6)).astype(np.float32) * 1e3,
        # The maximum 5 sits on shards 1 and 2 (twice on shard 1): the
        # smallest global index, 4, must win.
        argmax=np.asarray([[0, 1, 2], [4, 5, 5], [5, 1, 1],
                           [4, 0, 0]][:world], np.float32))


def _fold_inputs(world):
    rng = np.random.default_rng(10 + world)
    B = 4 * max(world, 2)
    return dict(ids=rng.permutation(B + 4)[:B].astype(np.int32),
                centers=rng.normal(size=(B, 3, 5)).astype(np.float32),
                mask=rng.random((B, 3)) < 0.8,
                w=rng.random((B, 3)).astype(np.float32), cap=B, kp=3, d=5)


def _cases(world, mixture, part, plane_inputs, lloyd_inputs, shifted, tmp):
    cases = {
        "round": dict(data=mixture.data, draws=_round_draws(mixture.data),
                      part=part, k=K, kp=KP, d=D),
        "primitives": _primitive_inputs(world),
        "fold": _fold_inputs(world),
    }
    pi = plane_inputs
    cases["routed"] = _routed_spec(pi, shifted,
                                   BURSTS if world == 4 else None)
    if world > 1:
        cases["plane"] = dict(plan=PLANE, round=pi["round"], reqs=pi["reqs"],
                              kvs=pi["kvs"], draws=pi["draws"])
        cases["drift"] = dict(plan=DRIFT, round=pi["round"], reqs=shifted[0],
                              kvs=shifted[1])
    if world == 2:
        cases["checkpoint"] = dict(plan=PLANE, round=pi["round"],
                                   reqs=pi["reqs"], kvs=pi["kvs"], cut=7,
                                   path=str(tmp / "sharded.npz"))
        cases["lloyd"] = {k: v for k, v in lloyd_inputs.items()
                          if k != "key"}
        cases["errors"] = {}
    if world == 4:
        reqs, kvs = _burst_stream(pi["fm"])
        cases["autoscale"] = dict(plan=AUTOSCALE, round=pi["round"],
                                  reqs=reqs, kvs=kvs, bursts=BURSTS)
    return cases


@pytest.fixture(scope="module")
def ranks(mixture, part, plane_inputs, lloyd_inputs, shifted,
          tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}, one spawn a world,
    started on first use."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"world{world}")
            done[world] = R.spawn(world, str(tmp), _cases(
                world, mixture, part, plane_inputs, lloyd_inputs, shifted,
                tmp))
        return done[world]

    return get


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        _assert_tree_equal(r[key], first)
    return first


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


# ------------------------------------------------------------ the mesh --


def _shard_order(shape, names, axes):
    """Global ranks of rank 0's group over ``axes`` in shard order."""
    sizes = dict(zip(names, shape))
    out = []
    for idx in np.ndindex(*[sizes[a] for a in axes]):
        coords = {a: 0 for a in names}
        coords.update(dict(zip(axes, idx)))
        out.append(int(np.ravel_multi_index([coords[a] for a in names],
                                            shape)))
    return out


@pytest.mark.parametrize("world", (2, 4))
def test_mesh_gather_is_in_shard_order(ranks, world):
    """A tiled gather lists the shards by their flat index over the
    axes, major to minor as listed, on a (w,) and a (2, 2) mesh."""
    res = ranks(world)
    meshes = [((world,), ("data",))]
    if world == 4:
        meshes.append(((2, 2), ("data", "model")))
    for shape, names in meshes:
        axes_list = [names] + ([names[::-1], names[:1], names[1:]]
                               if len(names) > 1 else [])
        for axes in axes_list:
            got = res[0]["primitives"][("gather", shape, axes)]
            order = _shard_order(shape, names, axes)
            np.testing.assert_array_equal(got[:, 0], order)
            np.testing.assert_array_equal(got[:, 1], np.arange(len(order)))
            b = res[0]["primitives"][("gather_bool", shape, axes)]
            np.testing.assert_array_equal(b[:, 0],
                                          [r % 2 == 0 for r in order])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_psum_is_the_same_bits_on_every_rank(ranks, world):
    """psum adds in shard order, the same bits on every rank; pmax and
    pmin are exact; the packed gather unpacks bit for bit."""
    res = ranks(world)
    xs = _primitive_inputs(world)["psum"]
    want = xs[0]
    for x in xs[1:]:
        want = want + x
    for name, ref in (("psum", want), ("pmax", xs.max(0)),
                      ("pmin", xs.min(0))):
        for r in res:
            np.testing.assert_array_equal(r["primitives"][name], ref,
                                          err_msg=name)
    many = res[0]["primitives"]["many"]
    flat = xs.reshape(-1)
    np.testing.assert_array_equal(many[0], flat)
    np.testing.assert_array_equal(many[1], flat > 0)
    assert many[2] is None
    np.testing.assert_array_equal(many[3], flat.astype(np.int32))
    one = res[0]["primitives"]["many_one_row"]
    np.testing.assert_array_equal(one[0], xs[:, 0] > 0)
    np.testing.assert_array_equal(one[1], xs[:, 0].astype(np.int32))


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_argmax_tie_goes_to_the_smallest_global_index(ranks, world):
    res = ranks(world)
    for r in res:
        assert r["primitives"]["argmax"] == 4  # shard 1, local row 1


# ----------------------------------------------------------- the round --


@pytest.mark.parametrize("weighted", (False, True))
@pytest.mark.parametrize("pname", ("all", "absent"))
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("world", WORLDS)
def test_round_matches_jax_simulated(ranks, jax_rounds, world, topology,
                                     pname, weighted):
    """Session.run under replicated and sharded, all devices present or
    devices 3 and 12 absent, unweighted or core-count weighted: the JAX
    package's simulated labels exactly, its tau within 1e-4, and the
    same bits on every rank."""
    res = ranks(world)
    labels, tau = _same_on_every_rank(res, "round")[(topology, pname,
                                                     weighted)]
    want_labels, want_tau = jax_rounds[(pname, weighted)]
    np.testing.assert_array_equal(labels, want_labels)
    _tau_close(tau, want_tau)
    assert labels.dtype == np.int32


@pytest.mark.parametrize("world", WORLDS)
def test_aggregate_incremental_sharded_matches_sequential(ranks, world):
    """The collective fold of each rank's rows == the one fold of the
    whole batch, bit for bit (ids past the capacity dropped)."""
    res = ranks(world)
    spec = _fold_inputs(world)
    st = S.aggregate_incremental(
        S.init_state(spec["cap"], spec["kp"], spec["d"], device="cpu"),
        torch.as_tensor(spec["ids"]), torch.as_tensor(spec["centers"]),
        torch.as_tensor(spec["mask"]), weights=torch.as_tensor(spec["w"]))
    got = _same_on_every_rank(res, "fold")
    for x, y in zip(got, st):
        np.testing.assert_array_equal(x, y.numpy())


# ----------------------------------------------------------- the plane --


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_plane_matches_single_device(ranks, single_plane, world):
    """PLANE_CHILD at 2 and 4 serve shards: labels, tau versions and the
    fold state equal the port's single-device plane bit for bit across
    an async refresh window, and the labels the JAX single-host plane's."""
    res = ranks(world)
    got = _same_on_every_rank(res, "plane")
    assert len(got["served"]) == len(single_plane["served"])
    for i, ((lbl, ver), (want, wver), (jlbl, jver)) in enumerate(zip(
            got["served"], single_plane["served"], single_plane["jax"])):
        np.testing.assert_array_equal(lbl, want, err_msg=f"request {i}")
        assert ver == wver == jver, (i, ver, wver, jver)
        np.testing.assert_array_equal(lbl, np.asarray(jlbl))
    for x, y in zip(got["state"], single_plane["state"]):
        np.testing.assert_array_equal(x, y)
    assert got["version"] == single_plane["version"] >= 1
    assert got["serve_shards"] == world
    assert got["serve_axes"] == ["data"]


def _assert_routed_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"request {i}")
        np.testing.assert_array_equal(g[2], w[2], err_msg=f"request {i}")
        assert (g[1], g[3], g[4]) == (w[1], w[3], w[4]), i


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_routed_step_matches_single_device(ranks, single_routed,
                                                   world):
    """serve_predict on the sharded routed step at 2 and 4 shards:
    labels, versions, predictions, clusters and routing equal the
    single-device port bit for bit, on every rank; C = 1 slot a cluster,
    and requests overflow a queue whose earlier request sits on another
    shard, which only the gathered votes can see."""
    got = _same_on_every_rank(ranks(world), "routed")
    want = single_routed
    _assert_routed_equal(got["served"], want["served"])
    for x, y in zip(got["state"], want["state"]):
        np.testing.assert_array_equal(x, y)
    assert got["heads"] == want["heads"] and got["heads"]["overflowed"] > 0
    b = ROUTED["batch_size"] // world
    cluster = [s[3] for s in want["served"]]
    cross = [i for i, s in enumerate(want["served"]) if not s[4] and any(
        cluster[j] == cluster[i] and (j % 8) // b != (i % 8) // b
        for j in range(i - i % 8, i))]
    assert cross, "no overflow across shards"


def test_routed_autoscale_switches_shard_counts_with_heads_on(
        ranks, single_routed):
    """Latency autoscaling at a grant of 4 with heads on: the active
    shard count takes 1, 2 and 4, and every routed result equals the
    single-device port's under the same plan, bit for bit."""
    got = _same_on_every_rank(ranks(4), "routed")["auto"]
    assert {s for s, _ in got["decisions"]} == {1, 2, 4}
    _assert_routed_equal(got["served"], single_routed["auto"]["served"])
    for x, y in zip(got["state"], single_routed["auto"]["state"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_drift_matches_single_device(ranks, single_routed, world):
    """tests/test_drift.py:345 in the port: a split_merge session on the
    sharded plane, heads off and on, equals the single-device one in
    labels, versions, predictions, fold state, mass, counters and the
    re-mapped heads, bit for bit, on every rank."""
    got = _same_on_every_rank(ranks(world), "drift")
    want = single_routed["drift"]
    _assert_tree_equal(got["off"], want["off"])
    _assert_tree_equal(got["linear"], want["linear"])
    assert want["off"]["counters"][1] > 0          # centers moved
    assert want["linear"]["counters"] == want["off"]["counters"]


def test_autoscale_switches_shard_counts_as_the_jax_controller(
        ranks, plane_inputs):
    """Latency autoscaling at a grant of 4: every decision's shards (and
    batch) equal the JAX controller's for the same queue, the shard
    count moves, and the labels, versions and fold state equal the
    single-device plane's under the same plan."""
    from repro.fed import autoscale as jauto
    res = ranks(4)
    got = _same_on_every_rank(res, "autoscale")
    reqs, kvs = _burst_stream(plane_inputs["fm"])
    ctl = jauto.AutoscaleController(
        "latency", max_batch=AUTOSCALE["batch_size"], granted=4, n_axes=1,
        base_ladder=AUTOSCALE["bucket_sizes"])
    want, at = [], 0
    for nb in BURSTS:
        d = ctl.observe(jauto.snapshot_queue(
            [r.shape[0] for r in reqs[at:at + nb]],
            AUTOSCALE["bucket_sizes"]))
        want.append((d.shards, d.batch_size))
        at += nb
    assert [(s, b) for s, b, _ in got["decisions"]] == want
    assert {s for s, _, _ in got["decisions"]} == {1, 2, 4}
    single = Session.from_round(FederationPlan(**AUTOSCALE, device="cpu"),
                                plane_inputs["round"], seed=3)
    served, _ = R.serve_bursts(single, reqs, kvs, BURSTS)
    for (lbl, ver), (want_l, want_v) in zip(got["served"], served):
        np.testing.assert_array_equal(lbl, want_l)
        assert ver == want_v
    for x, y in zip(got["state"], single.service.state):
        np.testing.assert_array_equal(x, y.numpy())


def test_sharded_checkpoint_replays_on_every_rank_and_single_device(
        ranks, plane_inputs):
    """A sharded session saved mid-stream (rank 0 writes) restores on
    every rank and serves the rest as the uninterrupted one, bit for
    bit; the same archive restored in a single-device session too."""
    res = ranks(2)
    got = _same_on_every_rank(res, "checkpoint")
    _assert_tree_equal(got["restored"], got["live"])
    _assert_tree_equal(got["restored_state"], got["state"])
    pi = plane_inputs
    single = Session.restore(got["path"], FederationPlan(**PLANE,
                                                         device="cpu"))
    again = single.serve_versioned(pi["reqs"][7:], pi["kvs"][7:])
    _assert_tree_equal([(np.asarray(a), v) for a, v in again],
                       [(np.asarray(a), v) for a, v in got["live"]])
    for x, y in zip(got["state"], single.service.state):
        np.testing.assert_array_equal(x, y.numpy())


# -------------------------------------------------- distributed lloyd --


def test_distributed_lloyd_matches_jax(ranks, lloyd_inputs):
    """distributed_lloyd at 2 ranks == the JAX function on a one-device
    mesh: labels exact, centers within 1e-4 of the largest entry."""
    from repro.core.distributed import distributed_lloyd
    from repro.utils.compat import make_mesh
    res = ranks(2)
    labels, centers = _same_on_every_rank(res, "lloyd")
    li = lloyd_inputs
    jl, jc = distributed_lloyd(make_mesh((1,), ("data",)),
                               jnp.asarray(li["data"]), li["k"],
                               key=li["key"], iters=li["iters"])
    np.testing.assert_array_equal(labels, np.asarray(jl))
    _tau_close(centers, jc)


# -------------------------------------------------------- plan errors --


@pytest.mark.parametrize("name,match", [
    ("axis", r"FederationPlan.mesh_axes=\('model',\) is invalid: axes "
             r"\['model'\] not in the mesh"),
    ("serve_axis", r"serve_axes=\('model',\): axes \['model'\] not in "
                   r"the mesh"),
    ("batch", r"batch_size=3 is invalid: must be divisible by the "
              r"serve_axes shard count 2"),
    ("nccl", r"make_mesh backend='nccl' is invalid here: NCCL takes one "
             r"rank per card")])
def test_mesh_plan_errors_name_the_field(ranks, name, match):
    import re
    for r in ranks(2):
        msg = r["errors"][name]
        assert msg is not None and re.search(match, msg), (name, msg)


def test_topology_needs_a_mesh():
    with pytest.raises(PlanError, match="topology='sharded' needs a mesh"):
        Session(FederationPlan(k=K, k_prime=KP, d=D, topology="sharded",
                               device="cpu"))
    with pytest.raises(PlanError, match=r"serve_axes=\('data',\) needs a "
                                        r"mesh"):
        Session(FederationPlan(k=K, k_prime=KP, d=D, serve_axes="data",
                               device="cpu"))


def test_serve_axes_with_heads_serves_routed_on_one_rank(ranks,
                                                         single_routed):
    """serve_axes with heads on, once refused, is a routed sharded serve:
    on a one-rank world it equals the single-device plane bit for bit."""
    got = ranks(1)[0]["routed"]
    _assert_routed_equal(got["served"], single_routed["served"])
    for x, y in zip(got["state"], single_routed["state"]):
        np.testing.assert_array_equal(x, y)
    assert got["heads"] == single_routed["heads"]


def test_staged_arrival_refuses_a_mesh_topology(mixture):
    """begin/fold run on the simulated topology only; refused before any
    collective (the session's checks read only the mesh's shape)."""
    from types import SimpleNamespace

    from repro_torch.fed.api import SessionError
    sess = Session(FederationPlan(k=K, k_prime=KP, d=D,
                                  topology="replicated", device="cpu"),
                   mesh=SimpleNamespace(shape={"data": 1}))
    with pytest.raises(SessionError, match="simulated topology"):
        sess.begin(0, mixture.data)
    with pytest.raises(SessionError, match="simulated topology"):
        sess.fold([0], key=0, data=mixture.data)


@pytest.mark.parametrize("heads", [(), ("--heads", "linear")],
                         ids=["plain", "heads"])
def test_attach_server_under_torchrun_two_ranks(tmp_path, heads):
    """The attachment server with --serve-axes under torchrun: two gloo
    ranks on the CPU serve the stream (through the sharded routed step
    with --heads), rank 0 prints, and the restored session serves the
    rest bit for bit."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.attach_server",
         "--serve-axes", "data", "--device", "cpu", "--requests", "16",
         "--refresh", "async", "--autoscale", "latency",
         "--checkpoint", str(tmp_path / "attach.npz"), *heads],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("round:") for ln in lines) == 1  # rank 0 only
    assert any("backend=gloo" in ln and "data=2" in ln for ln in lines)
    assert any("on 2 serve shard(s)" in ln for ln in lines)
    assert any("vs uninterrupted session: True" in ln for ln in lines)
    assert any(ln.startswith("heads[linear/ffn]: routed")
               for ln in lines) == bool(heads)


def test_attach_server_refuses_force_host_devices(capsys):
    from repro_torch.launch import attach_server
    with pytest.raises(SystemExit):
        attach_server.parse_args(["--force-host-devices", "8"])
    assert "torchrun --nproc-per-node" in capsys.readouterr().err


def test_assign_new_device_shard_matches_jax(mixture, jax_rounds):
    """A device joining after the round (Theorem 3.2, no collective):
    the JAX function's labels exactly, fed its draws."""
    from repro.core.distributed import assign_new_device_shard as jassign
    from repro.utils.compat import make_mesh

    from repro_torch.core.distributed import assign_new_device_shard
    _, tau = jax_rounds[("all", False)]
    new = late_device_stream(mixture.means, KP, 1, 4, n_range=(50, 51))[0][0]
    key = jax.random.PRNGKey(3)
    want = jassign(make_mesh((1,), ("data",)), jnp.asarray(new),
                   jnp.asarray(tau), KP, key=key)
    got = assign_new_device_shard(new, torch.tensor(tau), KP,
                                  source=JaxKeyGumbel(key))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
