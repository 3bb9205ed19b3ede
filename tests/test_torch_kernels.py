"""The port's kernels (repro_torch/kernels) against the JAX package's.

On the CPU the port's plain versions (kernels/ref.py) are held against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode,
on the same numpy inputs: integer outputs exactly, sums and centers
within rtol=atol=1e-5, and min squared distances within the
cancellation bound of the expanded form ||x||^2 - 2x.c + ||c||^2,
1e-6 * (||x_i||^2 + ||c_{a_i}||^2) + 1e-6 (not a flat atol). The CUDA
kernels are held against the plain versions by test_torch_gpu.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.kmeans_update import kmeans_update as pallas_update  # noqa: E402
from repro.kernels.pdist_argmin import pairwise_argmin as pallas_argmin  # noqa: E402
from repro.kernels.solve_attach import solve_attach_fused as pallas_solve  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_gpu import SOLVE_SHAPES, assert_min_dist, request_batch  # noqa: E402

T = torch.as_tensor


def _points(seed, n, d, k, *, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x = (rng.normal(size=lead + (n, d)) * 3).astype(np.float32)
    c = (rng.normal(size=lead + (k, d)) * 3).astype(np.float32)
    return rng, x, c


# -------------------------------------------------------- pdist_argmin --

ARGMIN_SHAPES = [(16, 8, 3), (70, 33, 7), (37, 20, 130), (64, 48, 12)]


@pytest.mark.parametrize("n,d,k", ARGMIN_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_assign_argmin_matches_jax(n, d, k, masked):
    """Port ref == JAX ref == Pallas (interpret): exact indices, distances
    within the cancellation bound. k=130 spans more than one center tile
    of both the Pallas kernel (128) and the CUDA kernel (32)."""
    rng, x, c = _points(n * 31 + k, n, d, k)
    cm = (rng.random(k) < 0.7) if masked else None
    if masked:
        cm[0] = True
    idx, val = ops.assign_argmin(T(x), T(c), None if cm is None else T(cm))
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    jidx, jval = jref.assign_argmin(jnp.asarray(x), jnp.asarray(c),
                                    None if cm is None else jnp.asarray(cm))
    pidx, pval = pallas_argmin(jnp.asarray(x), jnp.asarray(c),
                               None if cm is None else jnp.asarray(cm),
                               bn=32, bd=128, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    assert_min_dist(val.numpy(), np.asarray(jval), x, c, np.asarray(jidx))
    assert_min_dist(val.numpy(), np.asarray(pval), x, c, np.asarray(jidx))


def test_assign_argmin_batched_equals_per_entry():
    """The batch axis: one call over (B, n, d) with per-entry centers and
    masks equals B calls of the JAX reference."""
    rng, x, c = _points(5, 24, 10, 6, batch=3)
    cm = rng.random((3, 6)) < 0.6
    cm[:, 2] = True
    idx, val = ops.assign_argmin(T(x), T(c), T(cm))
    for b in range(3):
        jidx, jval = jref.assign_argmin(jnp.asarray(x[b]), jnp.asarray(c[b]),
                                        jnp.asarray(cm[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))
        assert_min_dist(val[b].numpy(), np.asarray(jval), x[b], c[b],
                        np.asarray(jidx))
    # A shared (k, d) center set broadcasts over the batch.
    sidx, _ = ops.assign_argmin(T(x), T(c[0]))
    for b in range(3):
        np.testing.assert_array_equal(
            sidx[b].numpy(),
            np.asarray(jref.assign_argmin(jnp.asarray(x[b]),
                                          jnp.asarray(c[0]))[0]))


def test_assign_argmin_ties_and_all_masked():
    """Ties go to the smallest index; an all-masked row gives idx 0 and
    exactly MASKED_DIST, as in the JAX reference."""
    x = np.zeros((5, 4), np.float32)
    c = np.stack([np.ones(4), np.full(4, 2.0), np.ones(4), -np.ones(4)]
                 ).astype(np.float32)
    idx, _ = ops.assign_argmin(T(x), T(c))
    jidx, _ = jref.assign_argmin(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert set(idx.tolist()) == {0}
    cm = np.array([False, True, True, True])
    idx, _ = ops.assign_argmin(T(x), T(c), T(cm))
    assert set(idx.tolist()) == {2}  # c[2] and c[3] tie; smaller wins
    none = np.zeros(4, bool)
    idx, val = ops.assign_argmin(T(x), T(c), T(none))
    jidx, jval = jref.assign_argmin(jnp.asarray(x), jnp.asarray(c),
                                    jnp.asarray(none))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert set(idx.tolist()) == {0}
    assert np.all(val.numpy() == np.float32(ref.MASKED_DIST))


def test_assign_argmin_chunks_rows(monkeypatch):
    """Above CHUNK_ROWS rows the points stream through in chunks with
    the same assignment as one call (distances to the cancellation
    bound: the CPU product's summation order depends on the row count)."""
    _, x, c = _points(9, 50, 6, 4, batch=2)
    whole = ops.assign_argmin(T(x), T(c))
    monkeypatch.setattr(ops, "CHUNK_ROWS", 16)
    chunked = ops.assign_argmin(T(x), T(c))
    torch.testing.assert_close(chunked[0], whole[0], rtol=0, atol=0)
    assert_min_dist(chunked[1].numpy(), whole[1].numpy(), x, c,
                    whole[0].numpy())


# ------------------------------------------------------- kmeans_update --

UPDATE_SHAPES = [(16, 8, 3), (100, 33, 7), (64, 48, 12), (40, 5, 40)]


@pytest.mark.parametrize("n,d,k", UPDATE_SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_update_matches_jax(n, d, k, weighted):
    """Sums and counts with assign = -1 rows and optional weights: port
    ref == JAX ref == Pallas (interpret) within rtol=atol=1e-5."""
    rng = np.random.default_rng(n * 7 + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.integers(-1, k, size=n).astype(np.int32)
    w = rng.uniform(0.5, 3.0, size=n).astype(np.float32) if weighted else None
    sums, cnt = ops.kmeans_update(T(x), T(a), k,
                                  None if w is None else T(w))
    jw = None if w is None else jnp.asarray(w)
    js, jc = jref.kmeans_update(jnp.asarray(x), jnp.asarray(a), k, jw)
    ps, pc = pallas_update(jnp.asarray(x), jnp.asarray(a), k, jw, bn=64,
                           interpret=True)
    for s_, c_ in ((js, jc), (ps, pc)):
        np.testing.assert_allclose(sums.numpy(), np.asarray(s_),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cnt.numpy(), np.asarray(c_),
                                   rtol=1e-5, atol=1e-5)
    assert sums.dtype == torch.float32 and cnt.dtype == torch.float32


def test_kmeans_update_batched_and_all_invalid():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 20, 5)).astype(np.float32)
    a = rng.integers(-1, 4, size=(3, 20)).astype(np.int32)
    a[1] = -1  # a batch entry with no valid point
    sums, cnt = ops.kmeans_update(T(x), T(a), 4)
    for b in range(3):
        js, jc = jref.kmeans_update(jnp.asarray(x[b]), jnp.asarray(a[b]), 4)
        np.testing.assert_allclose(sums[b].numpy(), np.asarray(js),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cnt[b].numpy(), np.asarray(jc))
    assert float(cnt[1].sum()) == 0.0 and float(sums[1].abs().sum()) == 0.0


# -------------------------------------------------------- solve_attach --

@pytest.mark.parametrize("B,n,d,kp,k,iters", SOLVE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_solve_attach_matches_jax(B, n, d, kp, k, iters, dtype):
    """Port ref == JAX ref == Pallas (interpret) in f32 and bf16 storage:
    labels and center labels exact, centers within rtol=atol=1e-5,
    min-dists within the cancellation bound."""
    tau, x, c0, cm, pm = request_batch(n * 13 + k, B, n, d, kp, k)
    got = ops.solve_attach(T(x), T(c0), T(tau), T(cm), T(pm),
                           max_iters=iters, dtype=dtype)
    args = [jnp.asarray(v) for v in (x, c0, tau, cm, pm)]
    want = jref.solve_attach(*args, max_iters=iters, dtype=dtype)
    pal = pallas_solve(*args, max_iters=iters, dtype=dtype, interpret=True)
    for other in (want, pal):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(other[0]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(other[3]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(other[2]),
                                   rtol=1e-5, atol=1e-5)
    # The min-dist bound is taken against the converged centers the
    # points were assigned to (stored values of the storage dtype).
    xs = torch.as_tensor(x).to(ref.store_dtype(dtype)).float().numpy()
    a, _ = ref.assign_argmin(T(xs), got[2], T(cm))
    for other in (want, pal):
        assert_min_dist(got[1].numpy(), np.asarray(other[1]), xs,
                        got[2].numpy(), a.numpy())
    assert got[2].dtype == torch.float32
    assert got[0].dtype == torch.int32 and got[3].dtype == torch.int32


def test_solve_attach_bf16_within_tolerance_of_f32():
    """On separated clusters bf16 storage moves no label, and centers
    stay within bf16 rounding of f32 (the bound of the JAX package's
    tests/test_solve_attach.py), and both match the JAX reference."""
    rng = np.random.default_rng(0)
    k, kp, d, B, n = 8, 4, 16, 4, 64
    means = (rng.normal(size=(k, d)) * 20).astype(np.float32)
    comp = rng.integers(0, k, size=(B, n))
    x = (means[comp] + rng.normal(size=(B, n, d))).astype(np.float32)
    c0 = (means[rng.integers(0, k, size=(B, kp))] + 0.5).astype(np.float32)
    f32 = ops.solve_attach(T(x), T(c0), T(means), max_iters=20, dtype="f32")
    b16 = ops.solve_attach(T(x), T(c0), T(means), max_iters=20, dtype="bf16")
    np.testing.assert_array_equal(b16[0].numpy(), f32[0].numpy())
    np.testing.assert_array_equal(b16[3].numpy(), f32[3].numpy())
    np.testing.assert_allclose(b16[2].numpy(), f32[2].numpy(),
                               rtol=2e-2, atol=2e-1)
    jb = jref.solve_attach(jnp.asarray(x), jnp.asarray(c0),
                           jnp.asarray(means), max_iters=20, dtype="bf16")
    np.testing.assert_array_equal(b16[0].numpy(), np.asarray(jb[0]))
    np.testing.assert_allclose(b16[2].numpy(), np.asarray(jb[2]),
                               rtol=1e-5, atol=1e-5)


def test_solve_attach_freezes_converged_requests():
    """Each request's loop is its own: a request served alone and in a
    batch with slower requests gives the same result."""
    tau, x, c0, cm, pm = request_batch(3, 4, 33, 7, 3, 7)
    whole = ops.solve_attach(T(x), T(c0), T(tau), T(cm), T(pm),
                             max_iters=30)
    for b in range(4):
        one = ops.solve_attach(T(x[b:b + 1]), T(c0[b:b + 1]), T(tau),
                               T(cm[b:b + 1]), T(pm[b:b + 1]), max_iters=30)
        for o, w in zip(one, whole):
            torch.testing.assert_close(o[0], w[b], rtol=0, atol=0)
