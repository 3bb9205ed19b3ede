"""repro_torch/core/local_kmeans.py (Algorithm 1) against
repro/core/local_kmeans.py on the same numpy inputs and k-means++ draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import local_kmeans as JLK  # noqa: E402
from repro.core.lloyd import kmeans_pp_init, lloyd  # noqa: E402
from repro_torch.core import local_kmeans as LK  # noqa: E402
from repro_torch.data.gaussian import structured_devices  # noqa: E402
from test_torch_prng import JaxRoundGumbel  # noqa: E402

T = torch.as_tensor
K, KP, D = 12, 3, 24


def _devices(seed=0, sep=30.0):
    fm = structured_devices(seed, k=K, d=D, k_prime=KP, m0=2,
                            n_per_comp_dev=12, sep=sep)
    rng = np.random.default_rng(seed)
    pm = rng.random(fm.data.shape[:2]) < 0.9
    kv = np.array([3, 2, 3, 1, 3, 3, 2, 3], np.int32)
    return fm.data, pm, kv


def test_project_top_k_matches_jax():
    """The projection onto the top-k_valid right singular subspace,
    within 1e-4 of the largest entry (the SVD's sign is free; the
    projection does not depend on it)."""
    data, pm, kv = _devices()
    got = LK.project_top_k(T(data), T(kv), KP, point_mask=T(pm))
    for z in range(data.shape[0]):
        want = np.asarray(JLK.project_top_k(
            jnp.asarray(data[z]), int(kv[z]), KP,
            point_mask=jnp.asarray(pm[z])))
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(got[z].numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=f"device {z}")


def test_subspace_project_matches_jax():
    data, pm, kv = _devices()
    got = LK.subspace_project(T(data), T(kv), KP, point_mask=T(pm))
    for z in (0, 3, 6):
        want = np.asarray(JLK.subspace_project(
            jnp.asarray(data[z]), int(kv[z]), KP,
            point_mask=jnp.asarray(pm[z])))
        np.testing.assert_allclose(got[z].numpy(), want, rtol=0,
                                   atol=1e-4 * np.max(np.abs(want)))


def _jax_steps_1_2(key, A, kv, pm):
    """The JAX package's Ahat and nu (Algorithm 1 steps 1-2) of one
    device."""
    Ahat = JLK.project_top_k(A, kv, KP, point_mask=pm)
    nu, cmask = kmeans_pp_init(key, Ahat, KP, point_mask=pm, k_valid=kv)
    nu = lloyd(Ahat, nu, center_mask=cmask, point_mask=pm,
               max_iters=8).centers
    return Ahat, nu, cmask


def test_core_sets_fed_jax_intermediates():
    """Step 3 fed the JAX package's Ahat and nu: core counts and masks
    exact, theta within 1e-5."""
    data, pm, kv = _devices()
    Z = data.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(4), Z)
    steps = [_jax_steps_1_2(keys[z], jnp.asarray(data[z]), int(kv[z]),
                            jnp.asarray(pm[z])) for z in range(Z)]
    Ahat = T(np.stack([np.asarray(s[0]) for s in steps]))
    nu = T(np.stack([np.asarray(s[1]) for s in steps]))
    cmask = T(np.stack([np.asarray(s[2]) for s in steps]))
    theta, counts = LK.core_sets(T(data), Ahat, nu, cmask, T(pm), KP)
    for z in range(Z):
        want = JLK.local_prepare(keys[z], jnp.asarray(data[z]), k_max=KP,
                                 k_valid=int(kv[z]),
                                 point_mask=jnp.asarray(pm[z]))
        np.testing.assert_array_equal(counts[z].numpy(),
                                      np.asarray(want.core_counts))
        np.testing.assert_array_equal(cmask[z].numpy(),
                                      np.asarray(want.center_mask))
        np.testing.assert_allclose(theta[z].numpy(), np.asarray(want.theta),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_subspace_iteration", [False, True])
def test_local_prepare_and_kmeans_with_shared_draws(use_subspace_iteration):
    """The whole of Algorithm 1 with the JAX package's draws on separated
    data: core counts, masks and local assignment exact, centers within
    1e-4 relative."""
    data, pm, kv = _devices(1)
    Z = data.shape[0]
    key = jax.random.PRNGKey(9)
    src = JaxRoundGumbel(key, Z)
    kw = dict(k_max=KP, k_valid=T(kv), point_mask=T(pm),
              use_subspace_iteration=use_subspace_iteration)
    g = src.draw(range(Z), KP, data.shape[1], "cpu")
    prep = LK.local_prepare(g, T(data), **kw)
    res = LK.local_kmeans(g, T(data), **kw)
    jprep = JLK.batched_local_prepare(
        src.keys, jnp.asarray(data), k_max=KP, k_valid=jnp.asarray(kv),
        point_mask=jnp.asarray(pm),
        use_subspace_iteration=use_subspace_iteration)
    jres = JLK.batched_local_kmeans(
        src.keys, jnp.asarray(data), k_max=KP, k_valid=jnp.asarray(kv),
        point_mask=jnp.asarray(pm),
        use_subspace_iteration=use_subspace_iteration)
    np.testing.assert_array_equal(prep.core_counts.numpy(),
                                  np.asarray(jprep.core_counts))
    np.testing.assert_array_equal(prep.center_mask.numpy(),
                                  np.asarray(jprep.center_mask))
    np.testing.assert_array_equal(res.assign.numpy(), np.asarray(jres.assign))
    np.testing.assert_array_equal(res.core_counts.numpy(),
                                  np.asarray(jres.core_counts))
    scale = float(np.max(np.abs(np.asarray(jres.centers))))
    np.testing.assert_allclose(res.centers.numpy(), np.asarray(jres.centers),
                               rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(prep.theta.numpy(), np.asarray(jprep.theta),
                               rtol=0, atol=1e-4 * scale)


def test_split_local_kw():
    kw, it = LK.split_local_kw({"approx_iters": 3, "max_iters": 7})
    assert kw == {"approx_iters": 3} and it == 7
    assert LK.split_local_kw({}) == ({}, 100)
