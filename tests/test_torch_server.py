"""repro_torch/core/server.py (Algorithm 2 and the incremental fold)
against repro/core/server.py on the same numpy inputs: seeds, z0 and
labels exact, tau within rtol=atol=1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import server as JS  # noqa: E402
from repro_torch.core import server as S  # noqa: E402

T = torch.as_tensor
Z, KP, K, D = 6, 3, 9, 8


def _reports(seed=0):
    """Device centers near k cluster means, with padded centers."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(K, D)) * 10
    comps = np.stack([rng.choice(K, KP, replace=False) for _ in range(Z)])
    centers = (means[comps] + rng.normal(size=(Z, KP, D)) * 0.3
               ).astype(np.float32)
    mask = np.ones((Z, KP), bool)
    mask[1, 2] = mask[4, 1] = False
    weights = rng.integers(1, 20, size=(Z, KP)).astype(np.float32)
    return centers, mask, weights


def _check_agg(got, want):
    np.testing.assert_array_equal(got.seeds_idx.numpy(),
                                  np.asarray(want.seeds_idx))
    assert int(got.z0) == int(want.z0)
    np.testing.assert_array_equal(got.center_labels.numpy(),
                                  np.asarray(want.center_labels))
    np.testing.assert_array_equal(got.seed_centers.numpy(),
                                  np.asarray(want.seed_centers))
    np.testing.assert_allclose(got.tau_centers.numpy(),
                               np.asarray(want.tau_centers),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("absent", [(), (0, 3)])
def test_aggregate_matches_jax(weighted, absent):
    """Unweighted, weighted, and with participation (absent devices'
    centers masked out of the aggregate)."""
    centers, mask, weights = _reports()
    part = ~np.isin(np.arange(Z), absent)
    m = mask & part[:, None]
    w = weights if weighted else None
    got = S.aggregate(T(centers), T(m), K,
                      weights=None if w is None else T(w))
    want = JS.aggregate(jnp.asarray(centers), jnp.asarray(m), K,
                        weights=None if w is None else jnp.asarray(w))
    _check_agg(got, want)
    assert got.seeds_idx.dtype == torch.int32
    post = S.attach_absent_devices(got.center_labels, T(centers), T(mask),
                                   got.tau_centers, T(part))
    jpost = JS.attach_absent_devices(want.center_labels,
                                     jnp.asarray(centers), jnp.asarray(mask),
                                     want.tau_centers, jnp.asarray(part))
    np.testing.assert_array_equal(post.numpy(), np.asarray(jpost))


def test_induced_labels_and_assign_new_device():
    rng = np.random.default_rng(2)
    cl = rng.integers(-1, K, size=(Z, KP)).astype(np.int32)
    la = rng.integers(-1, KP, size=(Z, 11)).astype(np.int32)
    np.testing.assert_array_equal(
        S.induced_labels(T(cl), T(la)).numpy(),
        np.asarray(JS.induced_labels(jnp.asarray(cl), jnp.asarray(la))))
    centers, mask, _ = _reports(3)
    tau = centers.reshape(-1, D)[::2][:K]
    got = S.assign_new_device(T(centers[1]), T(mask[1]), T(tau))
    want = JS.assign_new_device(jnp.asarray(centers[1]), jnp.asarray(mask[1]),
                                jnp.asarray(tau))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        S.core_weights(T(np.array([0.0, 2.0, 5.0]))).numpy(), [1.0, 2.0, 5.0])


def test_lloyd_round_divides_by_actual_mass():
    """Fractional masses average (never shrink toward the origin), and a
    zero-mass center keeps its seed."""
    x = np.array([[2.0, 0.0], [4.0, 0.0], [9.0, 9.0]], np.float32)
    M = np.array([[3.0, 0.0], [-5.0, -5.0]], np.float32)
    w = np.array([0.25, 0.25, 0.5], np.float32)
    fm = np.array([True, True, False])
    tau, lbl = S.lloyd_round(T(x), T(fm), T(M), 2, weights=T(w))
    jtau, jlbl = JS.lloyd_round(jnp.asarray(x), jnp.asarray(fm),
                                jnp.asarray(M), 2, weights=jnp.asarray(w))
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=1e-6)
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(jlbl))
    np.testing.assert_allclose(tau.numpy(), [[3.0, 0.0], [-5.0, -5.0]])


def test_incremental_fold_matches_jax_and_drops_over_capacity():
    """init_state / aggregate_incremental / finalize: the same state as
    the JAX package leaf by leaf, ids at or past the capacity dropped,
    re-delivery idempotent, any cohort order the same finalized round."""
    centers, mask, weights = _reports(4)
    cap = 5  # device 5 is past the capacity
    st = S.init_state(cap, KP, D, device="cpu")
    jst = JS.init_state(cap, KP, D)
    cohorts = [np.array([4, 0]), np.array([2, 5, 1]), np.array([0])]
    for ids in cohorts:
        st = S.aggregate_incremental(st, T(ids), T(centers[ids]),
                                     T(mask[ids]), weights=T(weights[ids]))
        jst = JS.aggregate_incremental(jst, jnp.asarray(ids),
                                       jnp.asarray(centers[ids]),
                                       jnp.asarray(mask[ids]),
                                       weights=jnp.asarray(weights[ids]))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert st.received.tolist() == [True, True, True, False, True]
    # Any order of the same cohorts gives the same state.
    st2 = S.init_state(cap, KP, D, device="cpu")
    for ids in reversed(cohorts):
        st2 = S.aggregate_incremental(st2, T(ids), T(centers[ids]),
                                      T(mask[ids]), weights=T(weights[ids]))
    for a, b in zip(st, st2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for weighted in (False, True):
        got = S.finalize(st, K - 1, weighted=weighted)
        want = JS.finalize(jst, K - 1, weighted=weighted)
        _check_agg(got, want)
    # Explicit epochs are stamped as given.
    st3 = S.aggregate_incremental(st, T([3]), T(centers[[3]]),
                                  T(mask[[3]]), epochs=T([42]))
    assert int(st3.epoch[3]) == 42 and bool(st3.received[3])
    assert not bool(st.received[3])  # the fold returns a new state


def test_convert_server_state_finalizes_like_jax():
    """A fold state built by the JAX package, carried across as numpy by
    convert.server_state, finalizes in the port to the same aggregate."""
    from repro_torch import convert
    centers, mask, weights = _reports(5)
    jst = JS.init_state(Z, KP, D)
    ids = np.array([5, 1, 2, 4])
    jst = JS.aggregate_incremental(jst, jnp.asarray(ids),
                                   jnp.asarray(centers[ids]),
                                   jnp.asarray(mask[ids]),
                                   weights=jnp.asarray(weights[ids]))
    st = convert.server_state(
        JS.ServerState(*[np.asarray(v) for v in jst]), device="cpu")
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert st.epoch.dtype == torch.int32 and st.mask.dtype == torch.bool
    _check_agg(S.finalize(st, K - 2, weighted=True),
               JS.finalize(jst, K - 2, weighted=True))
