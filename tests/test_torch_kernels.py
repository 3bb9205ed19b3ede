"""The port's kernels (repro_torch/kernels) against the JAX package's.

On the CPU the port's plain versions (kernels/ref.py) are held against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode,
on the same numpy inputs: integer outputs exactly, sums and centers
within rtol=atol=1e-5, and min squared distances within the
cancellation bound of the expanded form ||x||^2 - 2x.c + ||c||^2,
1e-6 * (||x_i||^2 + ||c_{a_i}||^2) + 1e-6 (not a flat atol). The CUDA
kernels are held against the plain versions by test_torch_gpu.py.
The ring-cache decode attention (swa_decode) within 2e-6 in f32 and
2e-2 in bf16 (the output rounded to bf16 once on each side).
The routed step's gather (moe_dispatch) is a copy and must match
exactly; its combine (moe_combine) exactly for top_k=1 and, for top_k=2,
within 1e-6 of the sum of the absolute products (two products summed,
which a compiler may contract into one FMA).
"""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.kmeans_update import kmeans_update as pallas_update  # noqa: E402
from repro.kernels.moe_dispatch import moe_combine as pallas_combine  # noqa: E402
from repro.kernels.moe_dispatch import moe_dispatch as pallas_dispatch  # noqa: E402
from repro.kernels.pdist_argmin import pairwise_argmin as pallas_argmin  # noqa: E402
from repro.kernels.solve_attach import solve_attach_fused as pallas_solve  # noqa: E402
from repro.kernels.swa_decode import swa_decode_attention as pallas_swa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_gpu import (MOE_SHAPES, SOLVE_SHAPES,  # noqa: E402
                            assert_combine_close, assert_min_dist,
                            moe_inputs, request_batch, swa_chunk_bias,
                            swa_inputs, with_inf_row)

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


class Split(NamedTuple):
    """The part of a launch plan of csrc/pdist_argmin.cu (``make_plan``)
    that sets the order of the kernel's sums and merges."""
    tk: int           # centers of a slice
    rows: int         # rows of a block
    slices: int       # slices of a center group
    parts: int        # parts of the features
    groups: int       # center groups
    part_groups: int  # 4-feature groups of a part
    tiles: int        # blocks along one row axis
    blocks: int


def make_split(B, n, d, k, shared, tk, rows, slices, parts, groups):
    """The Split of x (B, n, d) against k centers for the plan's choice
    of (tk, rows, slices, parts, groups)."""
    d4 = -(-d // 4)
    tiles = -(-(B * n if shared else n) // rows)
    return Split(tk, rows, slices, parts, groups, -(-d4 // parts), tiles,
                 (1 if shared else B) * tiles)


def split_argmin(x, c, cm, p):
    """The CUDA kernel's split and merge in plain PyTorch, for a Split
    ``p``: blocks of p.rows consecutive rows
    (the rows of every batch entry as one axis when c is shared (k, d),
    else within one entry), each dot product summed over p.parts parts
    of 4 p.part_groups features in part order, and the candidates taken
    in index order (the tk centers of a slice, the slices of a group,
    then the groups) with a strict ``<``. x: (B, n, d); c: (B, k, d) or
    (k, d); cm: (B, k), (k,) or None. The row and center norms are
    summed in the same parts. Returns (idx (B, n) int32, val (B, n)
    f32)."""
    B, n, d = x.shape
    k = c.shape[-2]
    shared = c.dim() == 2
    rows = x.reshape(B * n, d)
    per = B * n if shared else n
    parts = [(min(d, 4 * f * p.part_groups),
              min(d, 4 * (f + 1) * p.part_groups)) for f in range(p.parts)]
    idx = torch.zeros(B * n, dtype=torch.int32)
    val = torch.zeros(B * n)
    for blk in range(p.blocks):
        e, tile = divmod(blk, p.tiles)
        lo = e * per + tile * p.rows
        hi = min(lo + p.rows, e * per + per)
        xt = rows[lo:hi]
        cen = c if shared else c[e]
        fr = torch.arange(lo, hi)
        if cm is None:
            keep = torch.ones((hi - lo, k), dtype=torch.bool)
        else:
            keep = cm.expand(B, k)[fr // n]
        xn = sum(torch.sum(xt[:, j0:j1] ** 2, -1) for j0, j1 in parts)
        best = torch.full((hi - lo,), float("inf"))
        besti = torch.zeros(hi - lo, dtype=torch.int32)
        for grp in range(p.groups):
            for s in range(p.slices):
                bv = torch.full((hi - lo,), float("inf"))
                bi = torch.zeros(hi - lo, dtype=torch.int32)
                for t in range(p.tk):
                    g = (grp * p.slices + s) * p.tk + t
                    if g >= k:
                        continue
                    dot = sum(xt[:, j0:j1] @ cen[g, j0:j1] for j0, j1 in parts)
                    cn = sum(torch.sum(cen[g, j0:j1] ** 2) for j0, j1 in parts)
                    dist = torch.clamp_min(xn - 2.0 * dot + cn, 0.0)
                    dist = torch.where(keep[:, g], dist, ref.MASKED_DIST)
                    better = dist < bv
                    bv = torch.where(better, dist, bv)
                    bi = torch.where(better, g, bi)
                better = bv < best
                best = torch.where(better, bv, best)
                besti = torch.where(better, bi, besti)
        idx[lo:hi], val[lo:hi] = besti, best
    return idx.reshape(B, n), val.reshape(B, n)


# (B, n, d, k, shared, mask, plan (TK, R, S, F, groups)): small inputs
# under the plans the path shapes take on a full card (R = 32 with a
# ragged last tile, S = 10 slices of flat rows, F > 1 parts, k = 257 in
# center groups, TK = 4 at k' = 4). The card tests hold make_plan to
# these plans at the path shapes.
MIRROR_CASES = [
    (3, 70, 70, 10, False, "batch", (10, 32, 1, 2, 1)),
    (5, 10, 12, 100, True, "shared", (10, 8, 10, 1, 1)),
    (4, 23, 33, 17, False, "all_masked_entry", (10, 32, 2, 1, 1)),
    (1, 20, 300, 257, True, None, (10, 16, 9, 1, 3)),
    (2, 9, 8, 4, False, None, (4, 1, 1, 1, 1)),
    (3, 6, 5, 1, True, "all_masked", (4, 1, 1, 1, 1))]


@pytest.mark.parametrize("B,n,d,k,shared,mask,split", MIRROR_CASES)
def test_pdist_split_mirror_matches_jax(B, n, d, k, shared, mask, split):
    """The split and merge of csrc/pdist_argmin.cu (row tiles, center
    slices and groups, flat rows for shared c, the ordered strict ``<``
    merge) == JAX ref == Pallas (interpret) == the port's plain version,
    exactly, on integer-valued inputs (every sum exact) with duplicated
    centers (exact ties: the smallest index), masked centers and
    all-masked rows (idx 0, MASKED_DIST)."""
    rng = np.random.default_rng(B * 1000 + k)
    x = rng.integers(-4, 5, size=(B, n, d)).astype(np.float32)
    c = rng.integers(-4, 5, size=(k, d) if shared else (B, k, d)).astype(
        np.float32)
    if k > 1:
        c[..., 1::3, :] = c[..., 0:1, :]     # duplicates of center 0
        x[:, ::4] = c[0] if shared else c[:, :1]   # rows on center 0
    cm = None
    if mask is not None:
        cm = rng.random(k if mask in ("shared", "all_masked") else (B, k)
                        ) < 0.7
        cm[..., 0] = True
        if mask == "all_masked":
            cm[:] = False
        if mask == "all_masked_entry":
            cm[1] = False
    p = make_split(B, n, d, k, shared, *split)
    assert p.slices * p.groups * p.tk >= k
    got = split_argmin(T(x), T(c), None if cm is None else T(cm), p)
    plain = ref.assign_argmin(T(x), T(c), None if cm is None else T(cm))
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], plain[1], rtol=0, atol=0)
    xs = x.reshape(B * n, d) if shared else x
    jm = None if cm is None else jnp.asarray(cm)
    for e in range(1 if shared else B):
        xe, ce = (xs, c) if shared else (xs[e], c[e])
        me = jm if (jm is None or shared or jm.ndim == 1) else jm[e]
        gi = got[0].reshape(-1) if shared else got[0][e]
        gv = got[1].reshape(-1) if shared else got[1][e]
        for jidx, jval in (
                jref.assign_argmin(jnp.asarray(xe), jnp.asarray(ce), me),
                pallas_argmin(jnp.asarray(xe), jnp.asarray(ce), me, bn=32,
                              bd=128, interpret=True)):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(jval))
    if k > 1:   # rows on center 0 pick 0, not one of its copies
        assert bool((got[0][:, ::4][got[1][:, ::4] < ref.MASKED_DIST]
                     == 0).all())
    if mask == "all_masked":
        assert bool((got[0] == 0).all())
        assert bool((got[1] == np.float32(ref.MASKED_DIST)).all())


# ------------------------------------------------------- kmeans_update --

UPDATE_SHAPES = [(16, 8, 3), (100, 33, 7), (64, 48, 12), (40, 5, 40)]

# (n, d, k, case): the shapes above with mixed rows, then rows mostly at
# -1, one dominant cluster, k > n (empty clusters), and the round's
# server update (500 x 300 into k = 100) at a reduced n.
UPDATE_CASES = [pytest.param(n, d, k, "mixed", id=f"{n}-{d}-{k}")
                for n, d, k in UPDATE_SHAPES] + [
    pytest.param(200, 24, 10, "mostly_invalid", id="mostly_invalid"),
    pytest.param(300, 16, 8, "dominant", id="dominant"),
    pytest.param(12, 6, 30, "mixed", id="k_above_n"),
    pytest.param(100, 300, 100, "mixed", id="server")]


@pytest.mark.parametrize("n,d,k,case", UPDATE_CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_update_matches_jax(n, d, k, case, weighted):
    """Sums and counts with assign = -1 rows and optional weights: port
    ref == JAX ref == Pallas (interpret) within rtol=atol=1e-5. Cases:
    uniform in [-1, k); 92% of the rows at -1; 95% in one cluster; k > n
    (empty clusters: zero sums and counts)."""
    rng = np.random.default_rng(n * 7 + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.integers(-1, k, size=n).astype(np.int32)
    u = rng.random(n)
    if case == "mostly_invalid":
        a[u < 0.92] = -1
    elif case == "dominant":
        a[u < 0.95] = k // 2
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
    empty = np.bincount(a[a >= 0], minlength=k) == 0
    assert not bool(sums.numpy()[empty].any())
    assert not bool(cnt.numpy()[empty].any())


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


def split_solve(x, c0, tau, cm, pm, *, max_iters, dtype, R=64):
    """The CUDA kernel's split algorithm in plain PyTorch, one request at
    a time: the points cut into P = ceil(n / R) slices of R rows; each
    dot of a row with a center summed over 4 parts of d (of width
    round4(ceil(d / 4))) in part order; each step's partial sums and
    counts taken per slice, the rows of a slice added in row order, and
    the P partials summed in slice order; the loop stops at the first
    step where no row of any slice changed (its centers would equal the
    last step's) or at max_iters, and the final assignment is taken again
    only if the last step moved the centers. Returns the four outputs of
    ``ref.solve_attach`` and, per request, (steps run, converged)."""
    store = ref.store_dtype(dtype)
    xs, taus = x.to(store).float(), tau.to(store).float()
    B, n, d = xs.shape
    kp = c0.shape[1]
    P = max(1, -(-n // R))
    dq = 4 * -(-(-(-d // 4)) // 4)
    parts = [(min(d, q * dq), min(d, q * dq + dq)) for q in range(4)]

    def dots(rows, cen):
        out = torch.zeros((rows.shape[0], cen.shape[0]))
        for j0, j1 in parts:
            out = out + rows[:, j0:j1] @ cen[:, j0:j1].T
        return out

    outs, trace = [], []
    for b in range(B):
        xb, cen = xs[b], c0[b].to(store).float()
        xn = torch.sum(xb * xb, -1)

        def assign(cen):
            cn = torch.sum(cen * cen, -1)
            dist = torch.clamp_min(xn[:, None] - 2.0 * dots(xb, cen)
                                   + cn[None], 0.0)
            dist = torch.where(cm[b][None], dist, ref.MASKED_DIST)
            idx = torch.argmin(dist, -1).to(torch.int32)
            return (torch.where(pm[b], idx, -1),
                    torch.where(pm[b], dist.amin(-1), 0.0))

        prev = torch.full((n,), -2, dtype=torch.int32)
        fresh, steps, converged = False, 0, False
        for _ in range(max_iters):
            a, mind = assign(cen)
            fresh, steps = True, steps + 1
            sums, cnts, changed = [], [], False
            for p in range(P):
                lo, hi = p * R, min(n, (p + 1) * R)
                acc = torch.zeros((kp, d))
                cnt = torch.zeros((kp,), dtype=torch.int64)
                for i in range(lo, hi):
                    if a[i] >= 0:
                        acc[a[i]] += xb[i]
                        cnt[a[i]] += 1
                sums.append(acc)
                cnts.append(cnt)
                changed |= bool((a[lo:hi] != prev[lo:hi]).any())
            prev = a
            if not changed:
                converged = True
                break
            total = sums[0]
            for s in sums[1:]:
                total = total + s
            cnt = sum(cnts).float()
            new = (total / torch.clamp_min(cnt, 1.0)[:, None]).to(store)
            cen = torch.where(cnt[:, None] > 0, new.float(), cen)
            fresh = False
        if not fresh:
            a, mind = assign(cen)
        cn, tn = torch.sum(cen * cen, -1), torch.sum(taus * taus, -1)
        dt = torch.clamp_min(cn[:, None] - 2.0 * dots(taus, cen).T
                             + tn[None], 0.0)
        ctr = torch.where(cm[b], torch.argmin(dt, -1).to(torch.int32), -1)
        lbl = torch.where(a >= 0, ctr[torch.clamp(a, 0).long()], -1)
        outs.append((lbl, mind, cen, ctr))
        trace.append((steps, converged))
    return tuple(torch.stack(o) for o in zip(*outs)), trace


def split_batch(seed, B, n, d, kp, k):
    """Request 0: kp separated clusters started next to their means, so
    its assignment is stable at the second step; the others random, with
    request 1's second slice of 64 rows all masked (n > 64) and its last
    center masked."""
    rng = np.random.default_rng(seed)
    tau = (rng.normal(size=(k, d)) * 4).astype(np.float32)
    x = (rng.normal(size=(B, n, d)) * 3).astype(np.float32)
    c0 = (rng.normal(size=(B, kp, d)) * 3).astype(np.float32)
    mu = rng.normal(size=(kp, d)) * 30
    x[0] = mu[rng.integers(0, kp, size=n)] + rng.normal(size=(n, d))
    c0[0] = mu + 0.5
    cm = np.ones((B, kp), bool)
    cm[1, -1] = False
    pm = rng.random((B, n)) < 0.9
    pm[1, 64:128] = False
    return tau, x, c0, cm, pm


@pytest.mark.parametrize("B,n,d,kp,k", [(2, 40, 12, 4, 7),
                                        (3, 150, 20, 5, 9),
                                        (2, 1000, 12, 4, 7)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_solve_attach_split_mirror_matches_jax(B, n, d, kp, k, dtype):
    """The split rule of csrc/solve_attach.cu (P = 1, 3 and 16 slices of
    64 rows, the last one ragged; an all-masked slice and a masked
    center in request 1) == JAX ref == Pallas (interpret): labels and
    center labels exact, centers within 1e-5 of their largest entry,
    min-dists within the cancellation bound. Request 0 stops at its
    second step, the others run to max_iters."""
    iters = 3
    tau, x, c0, cm, pm = split_batch(n + kp, B, n, d, kp, k)
    got, trace = split_solve(T(x), T(c0), T(tau), T(cm), T(pm),
                             max_iters=iters, dtype=dtype)
    assert trace[0] == (2, True)
    assert all(t == (iters, False) for t in trace[1:]), trace
    assert -(-n // 64) in (1, 3, 16)
    args = [jnp.asarray(v) for v in (x, c0, tau, cm, pm)]
    want = jref.solve_attach(*args, max_iters=iters, dtype=dtype)
    pal = pallas_solve(*args, max_iters=iters, dtype=dtype, interpret=True)
    xs = torch.as_tensor(x).to(ref.store_dtype(dtype)).float().numpy()
    a, _ = ref.assign_argmin(T(xs), got[2], T(cm))
    for other in (want, pal):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(other[0]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(other[3]))
        scale = float(np.abs(np.asarray(other[2])).max())
        np.testing.assert_allclose(got[2].numpy(), np.asarray(other[2]),
                                   rtol=0, atol=1e-5 * scale)
        assert_min_dist(got[1].numpy(), np.asarray(other[1]), xs,
                        got[2].numpy(), a.numpy())


# ---------------------------------------------------- moe dispatch/combine --

def _pair(x, dtype):
    """The same values as a torch and a jax array of ``dtype``."""
    tx = torch.as_tensor(x)
    jx = jnp.asarray(x)
    if dtype == "bf16":
        return tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    return tx, jx


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("T,d,S", MOE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("all_invalid", [False, True])
def test_moe_dispatch_matches_jax(T, d, S, dtype, all_invalid):
    """Port ref == JAX ref == Pallas (interpret), bit for bit, with
    out-of-range routing indices (clipped) and d not a multiple of 4."""
    x, src, valid, _, _ = moe_inputs(T * 7 + d, T, d, S)
    if all_invalid:
        valid[:] = False
    tx, jx = _pair(x, dtype)
    got = ops.moe_dispatch(tx, torch.as_tensor(src), torch.as_tensor(valid))
    assert got.dtype == tx.dtype and got.shape == (S, d)
    want = jref.moe_dispatch(jx, jnp.asarray(src), jnp.asarray(valid))
    pal = pallas_dispatch(jx, jnp.asarray(src), jnp.asarray(valid), bd=128,
                          interpret=True)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), _np(pal))
    assert np.all(_np(got)[~valid] == 0.0)


# (T, d, S, a row of inf named only by zero gates); the ids of the
# finite cases are their shapes.
COMBINE_CASES = [(*shape, False) for shape in MOE_SHAPES] + [
    (40, 12, 30, True), (64, 7, 80, True)]


@pytest.mark.parametrize(
    "T,d,S,inf_row", COMBINE_CASES,
    ids=[f"{T}-{d}-{S}" + ("-inf_row" if inf else "")
         for T, d, S, inf in COMBINE_CASES])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_combine_matches_jax(T, d, S, inf_row, dtype, top_k):
    """Port ref == JAX ref == Pallas (interpret): exact for top_k=1,
    within 1e-6 of sum |g y| for top_k=2; zero gates drop their slot, and slots out of
    range are clipped (by the port and the JAX reference; the Pallas
    kernel is given them clipped). A zero gate is still multiplied: a
    row of +-inf named only by zero gates gives NaN across its tokens'
    outputs in all three, and nowhere else."""
    _, _, _, ybuf, _ = moe_inputs(S * 3 + d, T, d, S)
    _, _, _, _, (slot, gates) = moe_inputs(T + top_k, T, d, S, top_k=top_k)
    if inf_row:
        ybuf, slot, gates, nan_tokens = with_inf_row(ybuf, slot, gates,
                                                     top_k)
    ty, jy = _pair(ybuf, dtype)
    got = ops.moe_combine(ty, torch.as_tensor(slot), torch.as_tensor(gates),
                          top_k)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    want = jref.moe_combine(jy, jnp.asarray(slot), jnp.asarray(gates), top_k)
    # The Pallas kernel takes slots already clipped (its contract).
    pal = pallas_combine(jy, jnp.asarray(np.clip(slot, 0, S - 1)),
                         jnp.asarray(gates), top_k=top_k, bd=128,
                         interpret=True)
    nan = np.isnan(_np(got))
    if inf_row:
        assert np.array_equal(np.nonzero(nan.all(axis=1))[0], nan_tokens)
        assert nan.sum() == len(nan_tokens) * d
    else:
        assert not nan.any()
    finite = np.nan_to_num(ybuf, posinf=0.0, neginf=0.0)
    for other in (want, pal):
        other = _np(other)
        np.testing.assert_array_equal(np.isnan(other), nan)
        assert_combine_close(np.where(nan, 0, _np(got)),
                             np.where(nan, 0, other), finite, slot, gates,
                             top_k)


# ---------------------------------------------------------- swa_decode --

# The shapes of tests/test_kernels.py (b, h, kvh, dh, W) with rows of
# min(W, 17 i + 30) valid keys from slot 0, and a ring whose valid slots
# are scattered, the first tile of the first row all masked.
SWA_CASES = [(2, 8, 2, 64, 128, "prefix"), (1, 4, 4, 32, 200, "prefix"),
             (3, 8, 1, 128, 384, "prefix"), (2, 8, 2, 64, 200, "scattered")]


@pytest.mark.parametrize("b,h,kvh,dh,W,ring", SWA_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swa_decode_matches_jax(b, h, kvh, dh, W, ring, dtype):
    """Port ref == JAX ref == Pallas (interpret, 64-key window blocks)."""
    q, kw, vw, bias = swa_inputs(b + W, b, h, kvh, dh, W, ring)
    tq, jq = _pair(q, dtype)
    tk, jk = _pair(kw, dtype)
    tv, jv = _pair(vw, dtype)
    scale = 1.0 / np.sqrt(dh)
    got = ops.swa_decode_attention(tq, tk, tv, torch.as_tensor(bias), scale)
    assert got.dtype == tq.dtype and got.shape == (b, h, dh)
    want = jref.swa_decode_attention(jq, jk, jv, jnp.asarray(bias), scale)
    pal = pallas_swa(jq, jk, jv, jnp.asarray(bias), scale, bw=64,
                     interpret=True)
    tol = 2e-2 if dtype == "bf16" else 2e-6
    for other in (want, pal):
        np.testing.assert_allclose(_np(got), _np(other), rtol=0, atol=tol)


def split_combine(q, kw, vw, bias, scale, S, tile=4):
    """The CUDA kernel's split-window algorithm in plain PyTorch: the
    window cut into S chunks [s W / S, (s+1) W / S), each walked as an
    online softmax over tiles of ``tile`` keys from m = -1e30 (the TPU
    kernel's order: p = exp(s - m_new), l = l corr + sum p, acc = acc
    corr + p V), then the chunks' (m, l, acc) merged in chunk order:
    M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s / max(sum w_s
    l_s, 1e-30). f32 throughout; returns q's dtype."""
    b, h, dh = q.shape
    W, kvh = kw.shape[1], kw.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh).float()
    kf, vf = kw.float(), vw.float()
    states = []
    for s in range(S):
        m = torch.full((b, kvh, g), -1e30)
        l = torch.zeros((b, kvh, g))
        acc = torch.zeros((b, kvh, g, dh))
        for j0 in range(s * W // S, (s + 1) * W // S, tile):
            j1 = min(j0 + tile, (s + 1) * W // S)
            sc = torch.einsum("bkgd,bwkd->bkgw", qg, kf[:, j0:j1]) * scale
            sc = sc + bias[:, None, None, j0:j1]
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgw,bwkd->bkgd", p, vf[:, j0:j1])
            m = m_new
        states.append((m, l, acc))
    M = torch.stack([st[0] for st in states]).amax(0)
    lsum, out = torch.zeros_like(M), torch.zeros((b, kvh, g, dh))
    for m, l, acc in states:
        w = torch.exp(m - M)
        lsum = lsum + w * l
        out = out + w[..., None] * acc
    out = out / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


# SWA_CASES, a row whose middle chunk is all masked between chunks that
# hold keys (and an all-masked last row), and an all-masked row among
# scattered ones.
SPLIT_CASES = SWA_CASES + [(3, 8, 2, 64, 192, "middle"),
                           (3, 4, 2, 32, 150, "scattered")]


@pytest.mark.parametrize("b,h,kvh,dh,W,ring", SPLIT_CASES)
@pytest.mark.parametrize("S", [1, 3, 7])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swa_split_combine_matches_jax(b, h, kvh, dh, W, ring, S, dtype):
    """The split-and-combine rule of csrc/swa_decode.cu == port ref ==
    Pallas (interpret), within 2e-6 in f32 (2e-2 in bf16): the -1e30
    semantics of masked chunks and all-masked rows on this machine,
    where the kernel cannot run. The Pallas kernel pads the window to its
    block with -1e30 and zero values, so an all-masked row of a window
    that is not a multiple of the block averages over the padded window
    (a JAX package fault, ROADMAP.md section 3): there it is held on the
    rows that hold a key, and the "middle" case (W = 192) holds it on an
    all-masked row too."""
    q, kw, vw, bias = swa_inputs(b + W, b, h, kvh, dh, W,
                                 "scattered" if ring == "middle" else ring)
    if ring == "middle":
        bias = swa_chunk_bias(W, b, W, S)
        if S == 3:
            assert (bias[0, 64:128] < 0).all() and (bias[0, 63] == 0)
    tq, jq = _pair(q, dtype)
    tk, jk = _pair(kw, dtype)
    tv, jv = _pair(vw, dtype)
    scale = 1.0 / np.sqrt(dh)
    got = split_combine(tq, tk, tv, torch.as_tensor(bias), scale, S)
    assert got.dtype == tq.dtype and got.shape == (b, h, dh)
    port = ref.swa_decode_attention(tq, tk, tv, torch.as_tensor(bias), scale)
    pal = pallas_swa(jq, jk, jv, jnp.asarray(bias), scale, bw=64,
                     interpret=True)
    tol = 2e-2 if dtype == "bf16" else 2e-6
    np.testing.assert_allclose(_np(got), _np(port), rtol=0, atol=tol)
    rows = (bias == 0).any(-1) | (W % 64 == 0)
    np.testing.assert_allclose(_np(got)[rows], _np(pal)[rows], rtol=0,
                               atol=tol)
    if (bias[-1] < 0).all():   # the all-masked row: V's mean over W
        mean = tv[-1].float().mean(0).repeat_interleave(h // kvh, 0)
        np.testing.assert_allclose(_np(got[-1]), mean.numpy(), rtol=0,
                                   atol=tol)
