"""The scenario layer of the port (synthetic tasks and partitions, the
MLP, local SGD, FedAvg, IFCA, k-FED personalization, client selection,
the separation analysis and the k-means cost) against the JAX package,
on the same numpy inputs.

Tolerances (set from f32, not from the runs): data, partitions,
selection picks, clusterings, IFCA choices and the report's integer and
boolean parts exactly; parameters and losses after SGD within
atol 2e-5 + rtol 1e-4 (a few full-batch steps of f32 products summed
in another order); the separation report's norms, means and c_rs within
rtol 1e-4 (power iteration in f32), c_rs's diagonal (the root of a
cancelled distance) within sqrt(2 eps) max|mu| over the least
denominator; k-means costs within rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import _models as jmodels  # noqa: E402
from repro.core import kfed as jkfed  # noqa: E402
from repro.core import separation as jsep  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic_tasks as jtasks  # noqa: E402
from repro.fed import client as jclient  # noqa: E402
from repro.fed import fedavg as jfedavg  # noqa: E402
from repro.fed import ifca as jifca  # noqa: E402
from repro.fed import personalize as jpers  # noqa: E402
from repro.fed import selection as jsel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import kfed, separation  # noqa: E402
from repro_torch.data import partition, synthetic_tasks  # noqa: E402
from repro_torch.data.gaussian import structured_devices  # noqa: E402
from repro_torch.fed import client, fedavg, ifca, personalize  # noqa: E402
from repro_torch.fed import selection  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from test_torch_prng import JaxRoundGumbel  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4


def _params_close(got, want):
    want = jax.tree.map(np.asarray, want)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _init(seed, d_in, hidden, n_classes):
    """The JAX package's init_mlp, and the same parameters in the port."""
    jp = jmodels.init_mlp(jax.random.PRNGKey(seed), d_in, hidden, n_classes)
    return jp, convert.model_params(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _fed(Z=8, n=12, d=6, kp=1, seed=0):
    data = synthetic_tasks.rotation_tasks(np.random.default_rng(seed), Z=Z,
                                          n_per_dev=n, d=d, k=4, k_prime=kp)
    mask = np.ones((Z, n), bool)
    mask[1, n - 3:] = False          # a ragged device
    jd = {"x": jnp.asarray(data.x), "y": jnp.asarray(data.y),
          "mask": jnp.asarray(mask)}
    pd = {"x": torch.from_numpy(data.x), "y": torch.from_numpy(data.y),
          "mask": torch.from_numpy(mask)}
    return data, jd, pd


# ------------------------------------------------------------- data --


@pytest.mark.parametrize("kp", [1, 2])
def test_rotation_tasks_bit_for_bit(kp):
    a = synthetic_tasks.rotation_tasks(np.random.default_rng(3), Z=9,
                                       n_per_dev=11, d=8, k=4, k_prime=kp)
    b = jtasks.rotation_tasks(np.random.default_rng(3), Z=9, n_per_dev=11,
                              d=8, k=4, k_prime=kp)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_femnist_and_shakespeare_like_bit_for_bit():
    a = synthetic_tasks.femnist_like(np.random.default_rng(4), Z=12, d=8,
                                     mean_n=20)
    b = jtasks.femnist_like(np.random.default_rng(4), Z=12, d=8, mean_n=20)
    for xa, xb in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(a[2], b[2])
    a = synthetic_tasks.shakespeare_like(np.random.default_rng(5), Z=7, d=9,
                                         k_roles=3, n_per_dev=10)
    b = jtasks.shakespeare_like(np.random.default_rng(5), Z=7, d=9,
                                k_roles=3, n_per_dev=10)
    for xa, xb in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("how", ["structured", "power_law", "orphans",
                                 "iid", "pack"])
def test_partitions_bit_for_bit(how):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    y = rng.integers(0, 6, size=300)

    def part(mod):
        r = np.random.default_rng(7)
        if how == "structured":
            return mod.partition_structured(r, X, y, k=6, Z=10, k_prime=2)
        if how == "power_law":
            return mod.partition_structured(r, X, y, k=6, Z=10, k_prime=2,
                                            power_law=1.5)
        if how == "orphans":    # Z * k' < k: every cluster still placed
            return mod.partition_structured(r, X, y, k=6, Z=2, k_prime=2)
        if how == "iid":
            return mod.partition_iid(r, X, y, k=6, Z=9)
        xs, ys, _ = synthetic_tasks.femnist_like(r, Z=6, d=5, mean_n=15)
        return mod._pack(xs, ys, 10)

    for a, b in zip(part(partition), part(jpart)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ------------------------------------------------------ MLP and SGD --


def test_mlp_loss_and_accuracy_match_jax():
    _, jd, pd = _fed()
    jp, pp = _init(0, 6, 16, 10)
    for z in (0, 1):
        jdz = {k: v[z] for k, v in jd.items()}
        pdz = {k: v[z] for k, v in pd.items()}
        np.testing.assert_allclose(float(mlp.mlp_loss(pp, pdz)),
                                   float(jmodels.mlp_loss(jp, jdz)),
                                   rtol=RTOL)
        no_mask = {k: v for k, v in pdz.items() if k != "mask"}
        np.testing.assert_allclose(
            float(mlp.mlp_loss(pp, no_mask)),
            float(jmodels.mlp_loss(jp, {"x": jdz["x"], "y": jdz["y"]})),
            rtol=RTOL)
        assert float(mlp.mlp_accuracy(pp, pdz["x"], pdz["y"],
                                      pdz["mask"])) == float(
            jmodels.mlp_accuracy(jp, jdz["x"], jdz["y"], jdz["mask"]))
    p = mlp.init_mlp(torch.Generator().manual_seed(0), 6, 16, 10,
                     device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}


def test_local_sgd_matches_jax():
    """One client, three steps; point_mask only sets n (the loss sees
    data["mask"])."""
    _, jd, pd = _fed()
    jp, pp = _init(1, 6, 16, 10)
    pm = np.ones(12, bool)
    pm[:5] = False
    jdz = {k: v[1] for k, v in jd.items()}
    pdz = {k: v[1] for k, v in pd.items()}
    want = jclient.local_sgd(jmodels.mlp_loss, jp, jdz, lr=0.1, epochs=3,
                             point_mask=jnp.asarray(pm))
    got = client.local_sgd(mlp.mlp_loss, pp, pdz, lr=0.1, epochs=3,
                           point_mask=torch.from_numpy(pm))
    _params_close(got.params, want.params)
    assert float(got.n) == float(want.n) == 7.0
    np.testing.assert_allclose(float(got.loss), float(want.loss),
                               rtol=RTOL)


def test_summary_vector_and_delta_sketch_match_jax():
    _, jd, pd = _fed()
    jp, pp = _init(2, 6, 16, 10)
    jq, pq = _init(3, 6, 16, 10)

    def jembed(p, d):
        return jax.nn.relu(d["x"] @ p["w1"] + p["b1"])

    def embed(p, d):
        return torch.relu(d["x"] @ p["w1"] + p["b1"])

    for pm in (None, np.arange(12) % 3 > 0):
        want = jclient.summary_vector(
            jembed, jp, {k: v[0] for k, v in jd.items()},
            None if pm is None else jnp.asarray(pm))
        got = client.summary_vector(
            embed, pp, {k: v[0] for k, v in pd.items()},
            None if pm is None else torch.from_numpy(pm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    for dim in (64, 256):
        np.testing.assert_allclose(
            client.delta_sketch(pp, pq, dim).numpy(),
            np.asarray(jclient.delta_sketch(jp, jq, dim)), rtol=RTOL,
            atol=ATOL)


@pytest.mark.parametrize("members", [False, True])
def test_fedavg_round_matches_jax(members):
    _, jd, pd = _fed()
    jp, pp = _init(4, 6, 16, 10)
    cfg = fedavg.FedAvgConfig(lr=0.1, local_epochs=2, rounds=2)
    jcfg = jfedavg.FedAvgConfig(lr=0.1, local_epochs=2, rounds=2)
    pm = np.asarray(jd["mask"]).copy()
    pm[2, :6] = False
    member = (np.arange(8) % 3 != 1).astype(np.float32) if members else None
    kw = dict(point_mask=jnp.asarray(pm), member_mask=(
        None if member is None else jnp.asarray(member)))
    pkw = dict(point_mask=torch.from_numpy(pm), member_mask=(
        None if member is None else torch.from_numpy(member)))
    for _ in range(2):
        jp, jl = jfedavg.fedavg_round(jmodels.mlp_loss, jp, jd, jcfg, **kw)
        pp, pl = fedavg.fedavg_round(mlp.mlp_loss, pp, pd, cfg, **pkw)
        _params_close(pp, jp)
        np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)


def test_weighted_average_keeps_dtype():
    stack = {"a": torch.arange(6, dtype=torch.float32).reshape(3, 2),
             "b": torch.ones((3, 2), dtype=torch.bfloat16)}
    w = torch.tensor([1.0, 0.0, 3.0])
    out = fedavg.weighted_average(stack, w)
    want = jfedavg.weighted_average(
        {"a": jnp.arange(6, dtype=jnp.float32).reshape(3, 2),
         "b": jnp.ones((3, 2), jnp.bfloat16)}, jnp.asarray([1.0, 0.0, 3.0]))
    assert out["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(out["b"].float().numpy(),
                                  np.asarray(want["b"], np.float32))


def test_ifca_round_matches_jax():
    """Three models over two rounds: choices exact, parameters within
    tolerance; the model no client picks keeps its parameters."""
    _, jd, pd = _fed(Z=10)
    inits = [_init(10 + j, 6, 16, 10) for j in range(3)]
    jm = jax.tree.map(lambda *xs: jnp.stack(xs), *[a for a, _ in inits])
    pm_ = {k: torch.stack([b[k] for _, b in inits]) for k in inits[0][1]}
    # Model 2 calls every point class 0: no client picks it.
    jm = {**jm, "b2": jm["b2"].at[2, 0].set(50.0)}
    pm_["b2"][2, 0] = 50.0
    off = {k: v[2].clone() for k, v in pm_.items()}
    jcfg = jfedavg.FedAvgConfig(lr=0.1, local_epochs=2)
    cfg = fedavg.FedAvgConfig(lr=0.1, local_epochs=2)
    for _ in range(2):
        jm, jc, jl = jifca.ifca_round(jmodels.mlp_loss, jm, jd, jcfg,
                                      point_mask=jd["mask"])
        pm_, pc, pl = ifca.ifca_round(mlp.mlp_loss, pm_, pd, cfg,
                                      point_mask=pd["mask"])
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        _params_close(pm_, jm)
        np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
    assert 2 not in pc.tolist()
    for name, leaf in off.items():
        torch.testing.assert_close(pm_[name][2], leaf, rtol=0, atol=0)


# ------------------------------------------------- personalization --


def _features(data, kp, n_cls=10):
    """The Table 2 bench's features: per-chunk per-class prototype means."""
    feats = []
    for z in range(data.x.shape[0]):
        xs, ys = data.x[z], data.y[z]
        rows = []
        for idx in np.array_split(np.arange(xs.shape[0]), kp):
            proto = np.zeros((n_cls, xs.shape[1]), np.float32)
            for c in range(n_cls):
                sel = ys[idx] == c
                if sel.any():
                    proto[c] = xs[idx][sel].mean(0)
            rows.append(proto.reshape(-1))
        feats.append(np.stack(rows))
    return np.stack(feats)


@pytest.mark.parametrize("kp", [1, 2])
def test_kfed_personalize_matches_jax(kp):
    """k' = 1 (one cluster a device) and k' = 2 per chunk, with the JAX
    package's k-means++ draws: assignments exact, per-cluster models
    and loss histories within tolerance. At k' = 1 every device has one
    feature point (Algorithm 1 at n = k')."""
    Z = 16
    data, jd, pd = _fed(Z=Z, n=12, d=6, kp=kp, seed=kp)
    feats = _features(data, kp)
    jp, pp = _init(5, 6, 16, 10)
    jcfg = jfedavg.FedAvgConfig(lr=0.1, local_epochs=2, rounds=2)
    cfg = fedavg.FedAvgConfig(lr=0.1, local_epochs=2, rounds=2)
    key = jax.random.PRNGKey(2)
    jmodels_, jassign, jhist = jpers.kfed_personalize(
        key, jmodels.mlp_loss, jp, jd, jnp.asarray(feats), 4, jcfg,
        k_prime=kp, point_mask=jd["mask"], per_chunk=kp > 1)
    models, assign, hist = personalize.kfed_personalize(
        JaxRoundGumbel(key, Z), mlp.mlp_loss, pp, pd,
        torch.from_numpy(feats), 4, cfg, k_prime=kp,
        point_mask=pd["mask"], per_chunk=kp > 1)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
    assert assign.shape == ((Z,) if kp == 1 else (Z, kp))
    _params_close(models, jmodels_)
    np.testing.assert_allclose(np.asarray(hist), np.asarray(jhist),
                               rtol=RTOL, atol=ATOL)


def test_cluster_devices_majority_matches_jax():
    """Two feature points a device, one cluster a device by vote."""
    data = synthetic_tasks.rotation_tasks(np.random.default_rng(8), Z=12,
                                          n_per_dev=10, d=6, k=4,
                                          k_prime=2)
    feats = _features(data, 2)
    key = jax.random.PRNGKey(4)
    jvote, jres = jpers.cluster_devices(key, jnp.asarray(feats), 4, 2)
    vote, res = personalize.cluster_devices(JaxRoundGumbel(key, 12),
                                            feats, 4, 2, device="cpu")
    np.testing.assert_array_equal(vote.numpy(), np.asarray(jvote))
    np.testing.assert_array_equal(res.labels.numpy(),
                                  np.asarray(jres.labels))


# --------------------------------------------------------- selection --


def test_selection_picks_exact():
    losses = np.random.default_rng(9).random(40)
    losses[[3, 17]] = losses[5]                 # ties in the loss order
    clusters = np.random.default_rng(10).integers(0, 6, 40)
    few = np.zeros(40, int)                     # fewer clusters than m
    for seed in range(5):
        for fn, args in ((selection.random_selection, (40, 7)),
                         (selection.pow_d, (losses, 7, 15)),
                         (selection.kfed_pow_d, (losses, clusters, 7, 15)),
                         (selection.kfed_pow_d, (losses, few, 7, 15))):
            jfn = getattr(jsel, fn.__name__)
            np.testing.assert_array_equal(
                fn(np.random.default_rng(seed), *args),
                jfn(np.random.default_rng(seed), *args))


# -------------------------------------------------------- separation --


@pytest.fixture(scope="module")
def mixture():
    return structured_devices(3, k=8, d=12, k_prime=2, m0=3,
                              n_per_comp_dev=15, sep=4.0)


def test_spectral_norm_matches_jax():
    M = np.random.default_rng(11).normal(size=(50, 9)).astype(np.float32)
    got = float(separation.spectral_norm(torch.from_numpy(M)))
    np.testing.assert_allclose(got, float(jsep.spectral_norm(
        jnp.asarray(M))), rtol=RTOL)
    np.testing.assert_allclose(got, np.linalg.norm(M, 2), rtol=1e-3)


def test_separation_report_matches_jax(mixture):
    fm = mixture
    d = fm.data.shape[-1]
    A = fm.data.reshape(-1, d)
    lab = fm.labels.reshape(-1).astype(np.int32)
    lab[::17] = -1                                  # points left out
    kw = dict(k_prime=2, m0=3, c=0.3)
    want = jsep.separation_report(jnp.asarray(A), jnp.asarray(lab), 8,
                                  jnp.asarray(fm.presence),
                                  fm.data.shape[1], **kw)
    got = separation.separation_report(
        torch.from_numpy(A), torch.from_numpy(lab), 8,
        torch.from_numpy(fm.presence), fm.data.shape[1], **kw)
    for name in ("sizes", "active", "active_satisfied",
                 "inactive_satisfied"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("norm_ac", "means", "delta", "lam"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w,
                                   rtol=RTOL, atol=RTOL * np.abs(w).max(),
                                   err_msg=name)
    off = ~np.eye(8, dtype=bool)
    c_rs, w_rs = got.c_rs.numpy(), np.asarray(want.c_rs)
    np.testing.assert_allclose(c_rs[off], w_rs[off], rtol=RTOL)
    # On the diagonal both take the root of a cancelled expanded-norm
    # distance: at most sqrt(2 eps) max|mu| over the least denominator.
    mu = np.asarray(want.means)
    denom = np.sqrt(3) * 2 * np.asarray(want.delta).min()
    diag_tol = np.sqrt(2 * 1.2e-7) * np.linalg.norm(mu, axis=1).max() / denom
    assert np.abs(np.diag(c_rs)).max() <= diag_tol
    assert np.abs(np.diag(w_rs)).max() <= diag_tol
    assert 0.0 < float(got.active_satisfied) < 1.0
    # No active c_rs sits at c within the tolerance: the count is exact.
    assert np.abs(w_rs[np.asarray(want.active)] - 0.3).min() > 1e-3
    np.testing.assert_allclose(
        separation.tilde_deltas(got.norm_ac, got.sizes, 8).numpy(),
        np.asarray(jsep.tilde_deltas(want.norm_ac, want.sizes, 8)),
        rtol=RTOL)


def test_proximity_and_kmeans_cost_match_jax():
    # Separated enough that most points, not all, meet Definition 3.1.
    fm = structured_devices(3, k=8, d=12, k_prime=2, m0=3,
                            n_per_comp_dev=15, sep=8.0)
    d = fm.data.shape[-1]
    A = fm.data.reshape(-1, d)
    lab = fm.labels.reshape(-1).astype(np.int32)
    lab[::13] = -1
    want = np.asarray(jsep.proximity_satisfied(jnp.asarray(A),
                                               jnp.asarray(lab), 8))
    got = separation.proximity_satisfied(torch.from_numpy(A),
                                         torch.from_numpy(lab), 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    for labels in (fm.labels.astype(np.int32), lab.reshape(fm.labels.shape)):
        np.testing.assert_allclose(
            float(kfed.kmeans_cost_of_labels(torch.from_numpy(fm.data),
                                             torch.from_numpy(labels), 8)),
            float(jkfed.kmeans_cost_of_labels(jnp.asarray(fm.data),
                                              jnp.asarray(labels), 8)),
            rtol=1e-5)
