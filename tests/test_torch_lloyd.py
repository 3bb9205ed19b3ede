"""repro_torch/core/lloyd.py against repro/core/lloyd.py on the same numpy
inputs: indices exact, centers within rtol=atol=1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lloyd as JL  # noqa: E402
from repro_torch.core import lloyd as L  # noqa: E402
from test_torch_gpu import assert_min_dist  # noqa: E402
from test_torch_prng import JaxRoundGumbel  # noqa: E402

T = torch.as_tensor


def _blobs(seed, B, n, d, k, *, spread=1.0, sep=8.0):
    """B devices of n points around k random means each."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(B, k, d)) * sep
    lab = rng.integers(0, k, size=(B, n))
    x = means[np.arange(B)[:, None], lab] + rng.normal(size=(B, n, d)) * spread
    return rng, x.astype(np.float32)


def test_assign_points_and_update_centers_match_jax():
    rng, x = _blobs(0, 1, 60, 12, 5)
    x = x[0]
    c = x[rng.choice(60, 5, replace=False)]
    cm = np.array([True, True, False, True, True])
    pm = rng.random(60) < 0.85
    a, mind = L.assign_points(T(x), T(c), T(cm), T(pm))
    ja, jmind = JL.assign_points(jnp.asarray(x), jnp.asarray(c),
                                 jnp.asarray(cm), jnp.asarray(pm))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert np.all(a.numpy()[~pm] == -1) and np.all(mind.numpy()[~pm] == 0)
    assert_min_dist(mind.numpy(), np.asarray(jmind), x, c, a.numpy())
    new, cnt = L.update_centers(T(x), a, 5, T(c))
    jnew, jcnt = JL.update_centers(jnp.asarray(x), ja, 5, jnp.asarray(c))
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    # The masked center has no points and keeps its old value.
    np.testing.assert_array_equal(new.numpy()[2], c[2])
    cost = L.kmeans_cost(T(x), T(c), T(cm), T(pm))
    np.testing.assert_allclose(float(cost), float(JL.kmeans_cost(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(cm), jnp.asarray(pm))),
        rtol=1e-5)


def test_batched_lloyd_freezes_each_device_like_vmap():
    """Devices that converge at different iterations: per device the
    centers, assignment, iteration count and converged flag equal the
    JAX package's vmap of its while loop."""
    rng, x = _blobs(1, 5, 48, 6, 4, spread=2.5, sep=3.0)
    c0 = np.ascontiguousarray(x[:, :4] + rng.normal(size=(5, 4, 6)) * 0.1,
                              dtype=np.float32)
    cm = np.ones((5, 4), bool)
    cm[1, 3] = False
    pm = rng.random((5, 48)) < 0.9
    for max_iters in (3, 100):
        res = L.lloyd(T(x), T(c0), center_mask=T(cm), point_mask=T(pm),
                      max_iters=max_iters)
        jres = jax.vmap(lambda a, b, m, p: JL.lloyd(
            a, b, center_mask=m, point_mask=p, max_iters=max_iters))(
            jnp.asarray(x), jnp.asarray(c0), jnp.asarray(cm),
            jnp.asarray(pm))
        np.testing.assert_array_equal(res.iters.numpy(),
                                      np.asarray(jres.iters))
        np.testing.assert_array_equal(res.converged.numpy(),
                                      np.asarray(jres.converged))
        np.testing.assert_array_equal(res.assign.numpy(),
                                      np.asarray(jres.assign))
        np.testing.assert_allclose(res.centers.numpy(),
                                   np.asarray(jres.centers),
                                   rtol=1e-5, atol=1e-5)
    # The devices really did stop at different iterations.
    assert len(set(res.iters.tolist())) > 1
    # An unbatched call is one device of the batch.
    one = L.lloyd(T(x[2]), T(c0[2]), center_mask=T(cm[2]),
                  point_mask=T(pm[2]))
    assert int(one.iters) == int(res.iters[2])
    np.testing.assert_array_equal(one.assign.numpy(), res.assign[2].numpy())


def test_kmeans_pp_init_matches_jax_draws():
    """Fed the JAX package's Gumbel draws, the port picks exactly the
    same points, including k_valid < k and padded points."""
    rng, x = _blobs(2, 4, 40, 8, 5)
    pm = rng.random((4, 40)) < 0.9
    kv = np.array([5, 3, 1, 5], np.int32)
    key = jax.random.PRNGKey(11)
    src = JaxRoundGumbel(key, 4)
    centers, cm = L.kmeans_pp_init(src.draw(range(4), 5, 40, "cpu"), T(x), 5,
                                   point_mask=T(pm), k_valid=T(kv))
    jc, jcm = jax.vmap(lambda k_, a, p, v: JL.kmeans_pp_init(
        k_, a, 5, point_mask=p, k_valid=v))(
        src.keys, jnp.asarray(x), jnp.asarray(pm), jnp.asarray(kv))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    for z in range(4):
        for t in range(5):
            np.testing.assert_array_equal(
                centers[z, t].numpy(), np.asarray(jc[z, t]),
                err_msg=f"device {z}, k-means++ draw {t}")


def test_maxmin_seed_matches_jax():
    rng = np.random.default_rng(3)
    m, d, k = 30, 6, 9
    pts = (rng.normal(size=(m, d)) * 5).astype(np.float32)
    valid = rng.random(m) < 0.85
    init = np.zeros(m, bool)
    init[[2, 5, 7]] = True
    got = L.maxmin_seed(T(pts), T(valid), T(init), k)
    want = JL.maxmin_seed(jnp.asarray(pts), jnp.asarray(valid),
                          jnp.asarray(init), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert set(got.tolist()[:3]) == ({2, 5, 7} & set(np.nonzero(valid)[0]))


def test_lloyd_attach_is_the_fused_kernel_contract():
    """lloyd_attach == the staged lloyd -> nearest tau -> induced labels
    (labels exact, centers within 1e-5)."""
    rng, x = _blobs(4, 3, 32, 5, 3)
    tau = (rng.normal(size=(6, 5)) * 8).astype(np.float32)
    c0 = np.ascontiguousarray(x[:, :3])
    lbl, _, centers, clbl = L.lloyd_attach(T(x), T(c0), T(tau), max_iters=50)
    res = L.lloyd(T(x), T(c0), max_iters=50)
    ctr, _ = L.assign_points(res.centers, T(tau))
    want = torch.gather(ctr, 1, res.assign.long())
    torch.testing.assert_close(lbl, want, rtol=0, atol=0)
    torch.testing.assert_close(clbl, ctr, rtol=0, atol=0)
    torch.testing.assert_close(centers, res.centers, rtol=1e-5, atol=1e-5)
