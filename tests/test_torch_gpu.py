"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``gpu``; they skip without one). This file imports neither
jax nor the JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -p no:warnings --noconftest \\
        -m gpu tests/test_torch_gpu.py

Integer outputs exactly; sums and centers within rtol=1e-5, atol=1e-4
(kmeans_update with one cluster holding most of the rows: one f32 sum of
hundreds of terms, in another order than the plain version's product,
within chip_smoke.py's update tolerance of the f64 sums and of the plain
version; see assert_update_close);
min squared distances within the cancellation bound of the expanded form
||x||^2 - 2x.c + ||c||^2, 1e-6 * (||x_i||^2 + ||c_{a_i}||^2) + 1e-6.
The moe_dispatch gather bit for bit; the moe_combine kernel bit for bit
against the plain version for top_k <= 2 and against the sequential sum
(each product rounded, then added in j order) for any top_k, NaN where
they have NaN (a zero gate on a row of inf); the routed step's labels,
votes and keep mask exactly, its predictions within 1e-5 of their
largest magnitude (f32 products summed in another order).
swa_decode within 2e-5 (f32) or 2e-2 (bf16, one rounding of the output)
of the plain version's largest magnitude: an online softmax over tiles
sums in another order than one softmax over the window; its partial
entry point's states within 2e-5, and the ranks' blocks of a
context-parallel ring merged by its combine entry point bit for bit one
launch over the whole window with the same chunks.
The helpers here are shared with test_torch_kernels.py. The topologies
run here too: a one-rank NCCL round in the test's own process, and a
two-rank gloo world of processes sharing the card
(tests/_torch_mesh_ranks.py, which imports no jax either).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

T = torch.as_tensor

SOLVE_SHAPES = [(1, 16, 3, 2, 4, 100), (4, 33, 7, 3, 7, 9),
                (3, 40, 37, 5, 9, 7), (2, 64, 48, 4, 12, 50)]

# (T, d, S) of the routing kernels; d=7 is not a multiple of 4.
MOE_SHAPES = [(32, 8, 24), (100, 130, 48), (64, 7, 80)]

# (T, d, S) of the combine on the card besides MOE_SHAPES: the routed
# leg's (64, 128) from 80 slots, the Mixtral decode step's 4 tokens of
# 4096 from 16 slots, 64 tokens of 4096 (two chunks a row in f32), d=12
# (the vector path in f32, the scalar one in bf16), and T past 65,535 at
# a narrow d.
COMBINE_SHAPES = MOE_SHAPES + [(64, 128, 80), (4, 4096, 16), (64, 4096, 80),
                               (33, 12, 50), (70000, 8, 40)]


def assert_min_dist(got, want, x, c, idx):
    """|got - want| <= 1e-6 (||x_i||^2 + ||c_{a_i}||^2) + 1e-6."""
    x = np.asarray(x, np.float64)
    c = np.asarray(c, np.float64)
    xn = np.sum(x * x, -1)
    cn = np.sum(c * c, -1)
    idx = np.asarray(idx)
    if c.ndim == x.ndim:
        cni = np.take_along_axis(cn, np.maximum(idx, 0), axis=-1)
    else:
        cni = cn[np.maximum(idx, 0)]
    bound = 1e-6 * (xn + cni) + 1e-6
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= bound), float(np.max(err - bound))


def request_batch(seed, B, n, d, kp, k):
    rng = np.random.default_rng(seed)
    tau = (rng.normal(size=(k, d)) * 4).astype(np.float32)
    x = (rng.normal(size=(B, n, d)) * 3).astype(np.float32)
    c0 = (rng.normal(size=(B, kp, d)) * 3).astype(np.float32)
    cm = rng.random((B, kp)) < 0.8
    cm[:, 0] = True
    pm = rng.random((B, n)) < 0.9
    return tau, x, c0, cm, pm


def moe_inputs(seed, T, d, S, top_k=1):
    """(x (T, d) f32, src (S,) int32, valid (S,) bool, ybuf (S, d) f32,
    (slot (T*top_k,) int32, gates (T*top_k,) f32)); a few routing
    indices lie out of range (they are clipped) and a few gates are 0."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(T, d)) * 2).astype(np.float32)
    src = rng.integers(0, T, size=S).astype(np.int32)
    src[::7] = rng.choice([-3, T, T + 5], size=src[::7].shape)
    valid = rng.random(S) < 0.8
    ybuf = (rng.normal(size=(S, d)) * 2).astype(np.float32)
    slot = rng.integers(0, S, size=T * top_k).astype(np.int32)
    slot[::5] = rng.choice([-1, S, S + 2], size=slot[::5].shape)
    gates = rng.random(T * top_k).astype(np.float32)
    gates[::3] = 0.0
    return x, src, valid, ybuf, (slot, gates)


def swa_inputs(seed, b, h, kvh, dh, W, ring):
    """(q (b, h, dh), kw, vw (b, W, kvh, dh), bias (b, W)) as f32 numpy.
    ``ring="scattered"``: valid slots anywhere in the window, the first
    row's first tile all masked, and (b >= 3) the last row all masked;
    ``"prefix"``: row i holds min(W, 17 i + 30) keys from slot 0."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, dh)) * 0.5).astype(np.float32)
    kw = (rng.normal(size=(b, W, kvh, dh)) * 0.5).astype(np.float32)
    vw = (rng.normal(size=(b, W, kvh, dh)) * 0.5).astype(np.float32)
    if ring == "scattered":
        valid = rng.random((b, W)) < 0.6
        valid[0, :min(W - 1, 64)] = False
        valid[:, -1] = True
        if b >= 3:
            valid[-1] = False
    else:
        lens = np.minimum(W, 17 * np.arange(b) + 30)
        valid = np.arange(W)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, kw, vw, bias


def assert_swa_close(got, want, dtype):
    """|got - want| <= tol * max|want|: 2e-5 in f32, 2e-2 in bf16."""
    got, want = (torch.as_tensor(np.asarray(a, np.float32))
                 if not isinstance(a, torch.Tensor) else a.float().cpu()
                 for a in (got, want))
    tol = 2e-2 if dtype in (torch.bfloat16, "bfloat16") else 2e-5
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


def with_inf_row(ybuf, slot, gates, top_k):
    """A copy of the combine's inputs where row S // 2 of ybuf holds
    +inf and -inf and only entries whose gate is 0 name it: (ybuf, slot,
    gates, the tokens whose output must be all NaN, as 0 * inf is)."""
    ybuf, slot, gates = ybuf.copy(), slot.copy(), gates.copy()
    S = ybuf.shape[0]
    R = S // 2
    slot[np.clip(slot, 0, S - 1) == R] = (R + 1) % S
    zero = np.nonzero(gates == 0)[0][:3]
    slot[zero] = R
    ybuf[R] = np.inf
    ybuf[R, ::2] = -np.inf
    return ybuf, slot, gates, np.unique(zero // top_k)


# The kernel's arithmetic in plain PyTorch for any top_k: each product
# rounded, then added to a sum that starts at 0, j in order (for
# top_k <= 2 the plain version's bits).
sequential_combine = ref.sequential_combine


def assert_same_bits(got, want):
    """NaN in the same places, every other element bit for bit."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                       want.masked_fill(nan, 0).view(torch.int32))


def assert_combine_close(got, want, ybuf, slot, gates, top_k):
    """Exact for top_k=1; else |got - want| <= 1e-6 sum_j |g_j y_j|."""
    got, want = (a.cpu() if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.array(a)) for a in (got, want))
    if top_k == 1:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        return
    terms = ref.moe_combine(torch.as_tensor(ybuf).float().abs().cpu(),
                            torch.as_tensor(slot).cpu(),
                            torch.as_tensor(gates).abs().cpu(), top_k)
    excess = (got - want).abs() - 1e-6 * terms
    assert bool((excess <= 0).all()), float(excess.max())


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip with the reason (decided here, at run
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,k", [(1, 5, 3, 2), (3, 70, 33, 7),
                                     (50, 400, 300, 10), (2, 130, 129, 45)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pdist_argmin_matches_plain(cuda_device, B, n, d, k, dtype):
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    g = torch.Generator().manual_seed(n + k)
    x = (torch.randn(B, n, d, generator=g) * 3).to(cuda_device, dtype)
    c = (torch.randn(B, k, d, generator=g) * 3).to(cuda_device, dtype)
    cm = (torch.rand(B, k, generator=g) < 0.7).to(cuda_device)
    cm[:, 0] = True
    idx, val = pdist_argmin(x, c, cm)
    ridx, rval = ref.assign_argmin(x, c, cm)
    torch.testing.assert_close(idx, ridx, rtol=0, atol=0)
    assert_min_dist(val.cpu().numpy(), rval.cpu().numpy(),
                    x.float().cpu().numpy(), c.float().cpu().numpy(),
                    ridx.cpu().numpy())


# (B, n, d, k, shared, masked): the shapes the k-FED paths launch
# pdist_argmin at: the round's local Lloyd steps, a serve batch's
# local_prepare, the server's Lloyd round (2-D x), the Theorem 3.2 attach
# of (Z, k', d) device centers, the routed leg's local_prepare, and the
# serve path's refresh.
PDIST_PATH_SHAPES = [(50, 400, 300, 10, False, True),
                     (8, 1024, 300, 10, False, True),
                     (1, 500, 300, 100, True, False),
                     (50, 10, 300, 100, True, False),
                     (64, 64, 128, 4, False, True),
                     (1, 10240, 300, 100, True, False)]

# The plan (TK, R, S, F, center groups) of each path shape in f32 on a
# card of 132 SMs (an H100 SXM), as PERF.md gives them.
PDIST_PATH_PLANS = [(10, 32, 1, 8, 1), (10, 32, 1, 8, 1), (10, 8, 10, 3, 1),
                    (10, 8, 10, 3, 1), (4, 32, 1, 4, 1), (10, 32, 10, 1, 1)]


def pdist_inputs(seed, B, n, d, k, shared, masked, device, dtype,
                 offset=0):
    """x (B, n, d) (or (n, d) for B = 1 with shared centers), c (k, d)
    shared or (B, k, d), a (B, k) mask (center 0 kept) or None, drawn
    from a seeded generator, stored in ``dtype``. With ``offset`` > 0,
    x and c start ``offset`` elements into their storage (a base that
    is not 16-byte aligned)."""
    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        flat = torch.randn(offset + int(np.prod(shape)), generator=g) * 3
        return flat.to(device, dtype)[offset:].view(*shape)

    x = draw(n, d) if shared and B == 1 else draw(B, n, d)
    c = draw(k, d) if shared else draw(B, k, d)
    cm = None
    if masked:
        cm = (torch.rand(B, k, generator=g) < 0.8).to(device)
        cm[:, 0] = True
    return x, c, cm


def assert_argmin_close(x, c, cm, idx, val):
    """The kernel's (idx, val) against the plain version on the same
    inputs: indices exact except where the kernel's pick is within the
    distance tolerance of the plain minimum (a tie at f32 precision);
    distances within the tolerance."""
    ridx, rval = ref.assign_argmin(x, c, cm)
    xf, cf = x.float().cpu(), c.float().cpu()
    idx, val, ridx, rval = (a.cpu() for a in (idx, val, ridx, rval))
    diff = idx != ridx
    if bool(diff.any()):
        dist = ref.pairwise_sq_dists(xf, cf)
        if cm is not None:
            dist = torch.where(cm.cpu().unsqueeze(-2), dist, ref.MASKED_DIST)
        at = torch.gather(dist, -1, idx.long().unsqueeze(-1)).squeeze(-1)
        assert_min_dist(at[diff].numpy(), rval[diff].numpy(),
                        xf.numpy(), cf.numpy(), ridx.numpy())
    assert_min_dist(val.numpy(), rval.numpy(), xf.numpy(), cf.numpy(),
                    ridx.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,k,shared,masked", PDIST_PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pdist_argmin_path_shapes(cuda_device, B, n, d, k, shared,
                                      masked, dtype):
    """Every shape the paths launch, shared (k, d) centers with a 2-D x
    and with a batched x included, in f32 and bf16."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    x, c, cm = pdist_inputs(B * n + k, B, n, d, k, shared, masked,
                            cuda_device, dtype)
    idx, val = pdist_argmin(x, c, cm)
    assert idx.shape == x.shape[:-1] and idx.dtype == torch.int32
    assert_argmin_close(x, c, cm, idx, val)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,want", zip(PDIST_PATH_SHAPES,
                                           PDIST_PATH_PLANS))
def test_gpu_pdist_argmin_path_plans(cuda_device, shape, want):
    """The plan of every path shape gives a block to at least a third of
    the SMs (rows of shared centers as one axis), and on a card of 132
    SMs is the one that PERF.md gives."""
    from repro_torch.kernels.pdist_argmin import plan
    B, n, d, k, shared, _ = shape
    p = plan(B, n, k, d, shared, torch.float32, cuda_device)
    assert 3 * p.blocks >= p.sms
    assert p.blocks == (1 if shared else B) * -(-(B * n if shared else n)
                                                // p.rows)
    assert p.threads <= 512 and p.per_sm >= 1
    if p.sms == 132:
        assert (p.tk, p.rows, p.slices, p.parts, p.groups) == want


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 17, 100, 257])
@pytest.mark.parametrize("B,n,d,shared,offset", [
    (3, 70, 33, False, 0),      # ragged n, d not a multiple of 4
    (5, 37, 33, True, 0),       # flat rows of 5 entries, d ragged
    (3, 70, 36, False, 1),      # d a multiple of 4, unaligned bases
    (1, 301, 64, True, 0)])     # 2-D x, the 16-byte copies
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pdist_argmin_k_and_layouts(cuda_device, k, B, n, d, shared,
                                        offset, dtype):
    """k of one, part of one, two and many center slices (k = 257 at
    d = 300, more than a block takes at once, below); the copies by 4
    elements and the element-wise ones."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    x, c, cm = pdist_inputs(k * 7 + n, B, n, d, k, shared, True, cuda_device,
                            dtype, offset)
    if offset:
        assert x.data_ptr() % 16 and c.data_ptr() % 16
    for mask in (None, cm[0] if shared else cm):
        idx, val = pdist_argmin(x, c, mask)
        assert_argmin_close(x, c, mask, idx, val)


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True])
def test_gpu_pdist_argmin_center_groups(cuda_device, shared):
    """k = 257 centers of d = 300 are more than a block takes at once:
    they are staged and merged in three groups."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin, plan
    B, n, d, k = 2, 90, 300, 257
    x, c, cm = pdist_inputs(11, B, n, d, k, shared, True, cuda_device,
                            torch.float32)
    assert plan(B, n, k, d, shared, x.dtype, cuda_device).groups == 3
    idx, val = pdist_argmin(x, c, cm)
    assert_argmin_close(x, c, cm, idx, val)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16, 32])
def test_gpu_pdist_argmin_every_row_count(cuda_device, monkeypatch, rows):
    """Every row count a plan may take gives the plain version's answer
    (the server's shape, masked; the plan restricted to one count)."""
    from repro_torch.kernels import pdist_argmin as pa
    x, c, cm = pdist_inputs(5, 1, 500, 300, 100, True, True, cuda_device,
                            torch.float32)
    monkeypatch.setattr(pa, "ROWS", rows)
    assert pa.plan(1, 500, 100, 300, True, x.dtype, cuda_device).rows == rows
    idx, val = pa.pdist_argmin(x, c, cm[0])
    assert_argmin_close(x, c, cm[0], idx, val)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,k,shared", [(4, 100, 300, 10, False),
                                            (1, 500, 300, 100, True),
                                            (6, 50, 33, 257, True),
                                            (64, 64, 128, 4, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pdist_argmin_duplicates_pick_smallest(cuda_device, B, n, d, k,
                                                   shared, dtype):
    """Copies of a center give bit-identical distances, so the smallest
    index is required exactly: every row lies next to a center that has
    a later copy, and must pick the first one."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    x, c, _ = pdist_inputs(k + n, B, n, d, k, shared, False, cuda_device,
                           dtype)
    cb = c if shared else c.view(B, k, d)
    half = max(1, k // 2)
    src = torch.arange(k, device=cuda_device) % half
    cb.copy_(cb[..., src, :].clone())          # center j copies j % half
    g = torch.Generator().manual_seed(n)
    pick = torch.randint(0, k, x.shape[:-1], generator=g).to(cuda_device)
    near = cb[pick] if shared else torch.gather(
        cb, 1, pick.unsqueeze(-1).expand(-1, -1, d))
    x.copy_(near + 0.01 * torch.randn(x.shape, generator=g).to(
        cuda_device, dtype))
    idx, val = pdist_argmin(x, c, None)
    assert torch.equal(idx, (pick % half).int())
    assert_argmin_close(x, c, None, idx, val)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,k,shared", [(1, 200, 320, 4, True),
                                            (50, 400, 300, 10, False),
                                            (1, 500, 300, 100, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pdist_argmin_rows_on_centers_are_at_zero(cuda_device, B, n, d,
                                                      k, shared, dtype):
    """Plans of several feature parts (F > 1), whose part sums are added
    under Kahan's compensation: a row equal to a center is at a distance
    of exactly 0 from it (the row's norm, the center's and their product
    take the same operations), as the server's seeds, which are some of
    its rows, need. Every row is held to the distances taken in f64
    (the plain f32 version is itself off by more than the tolerance on
    rows equal to a center at d=300 and these norms): within the
    tolerance, and the exact argmin but for ties within it."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin, plan
    x, c, _ = pdist_inputs(n + k, B, n, d, k, shared, False, cuda_device,
                           dtype)
    assert plan(B, n, k, d, shared, dtype, cuda_device).parts > 1
    cb = c if shared else c.view(B, k, d)
    on = torch.arange(0, n, 7, device=cuda_device)
    want = on % k
    if shared:
        x[on] = cb[want]
    else:
        x[:, on] = cb[:, want]
    idx, val = pdist_argmin(x, c, None)
    assert torch.equal(idx[..., on], want.int().expand_as(idx[..., on]))
    assert bool((val[..., on] == 0).all())
    xd, cd = x.double().cpu(), c.double().cpu()
    xn, cn = (xd * xd).sum(-1), (cd * cd).sum(-1)
    exact = (xn.unsqueeze(-1) - 2.0 * (xd @ cd.transpose(-1, -2))
             + cn.unsqueeze(-2)).clamp_min(0.0)
    emin, eidx = exact.min(-1)
    tol = 1e-6 * (xn + torch.gather(cn.expand(*xn.shape[:-1], k), -1,
                                    eidx)) + 1e-6
    assert bool(((val.cpu().double() - emin).abs() <= tol).all())
    at = torch.gather(exact, -1, idx.cpu().long().unsqueeze(-1)).squeeze(-1)
    assert bool(((idx.cpu().long() == eidx) | ((at - emin) <= tol)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,k,shared", [(1, 3600, 53, 8, False),
                                            (60, 300, 53, 1, False),
                                            (864, 40, 60, 1, False),
                                            (1, 34560, 60, 36, True),
                                            (1, 10240, 300, 100, True)])
def test_gpu_pdist_argmin_one_part_is_compensated(cuda_device, B, n, d, k,
                                                  shared):
    """Plans of one feature part (the Figure 2 and 3 legs' shapes, and
    the serve refresh's), whose running sums are added under Kahan's
    compensation, on rows near their centers at large norms (the
    cancellation of the paths): a row equal to a center is at exactly 0;
    every distance is within the tolerance of the f64 one, and the
    largest error is no larger than the f32 plain version's."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin, plan
    assert plan(B, n, k, d, shared, torch.float32, cuda_device).parts == 1
    g = torch.Generator().manual_seed(n + d)
    c = torch.randn(k, d, generator=g) * 3 + 20
    if not shared:
        c = c.expand(B, k, d) + torch.randn(B, k, d, generator=g)
    pick = torch.randint(0, k, (B, n), generator=g)
    x = (torch.gather(c.expand(B, k, d), 1, pick.unsqueeze(-1).expand(
        B, n, d)) + 0.3 * torch.randn(B, n, d, generator=g))
    on = torch.arange(0, n, 7)
    x[:, on] = torch.gather(c.expand(B, k, d), 1, pick[:, on].unsqueeze(
        -1).expand(B, len(on), d))
    if shared:
        x = x.reshape(B * n, d)
    x, c = x.contiguous().to(cuda_device), c.contiguous().to(cuda_device)
    idx, val = pdist_argmin(x, c, None)
    plain_idx, plain_val = ref.assign_argmin(x, c)
    xd, cd = x.double().cpu(), c.double().cpu()
    xn, cn = (xd * xd).sum(-1), (cd * cd).sum(-1)
    exact = (xn.unsqueeze(-1) - 2.0 * (xd @ cd.transpose(-1, -2))
             + cn.unsqueeze(-2)).clamp_min(0.0)
    emin, eidx = exact.min(-1)
    tol = 1e-6 * (xn + torch.gather(cn.expand(*xn.shape[:-1], k), -1,
                                    eidx)) + 1e-6
    err = (val.cpu().double() - emin).abs()
    assert bool((err <= tol).all())
    assert float((err / tol).max()) <= float(
        ((plain_val.cpu().double() - emin).abs() / tol).max())
    rows = val.view(B, n)[:, on] if shared else val[:, on]
    assert bool((rows == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("k,d", [(10, 300), (100, 300), (257, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pdist_argmin_all_masked_rows(cuda_device, k, d, dtype):
    """Rows whose every center is masked get idx 0 and exactly
    MASKED_DIST: a batch entry with an all-False mask row, and a shared
    center set with an all-False mask."""
    from repro_torch.kernels.pdist_argmin import pdist_argmin
    x, c, cm = pdist_inputs(k + d, 3, 40, d, k, False, True, cuda_device,
                            dtype)
    cm[1] = False
    idx, val = pdist_argmin(x, c, cm)
    assert bool((idx[1] == 0).all())
    assert bool((val[1] == np.float32(ref.MASKED_DIST)).all())
    assert_argmin_close(x, c, cm, idx, val)
    none = torch.zeros(k, dtype=torch.bool, device=cuda_device)
    idx, val = pdist_argmin(x, c[0].contiguous(), none)
    assert bool((idx == 0).all())
    assert bool((val == np.float32(ref.MASKED_DIST)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,k,shared,masked", PDIST_PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pdist_argmin_runs_twice_alike(cuda_device, B, n, d, k, shared,
                                           masked, dtype):
    """Two calls give the same bits (no atomics: every sum and merge in
    a fixed order), and each counts one launch."""
    from repro_torch.kernels import pdist_argmin as pa
    x, c, cm = pdist_inputs(B + n + k, B, n, d, k, shared, masked,
                            cuda_device, dtype)
    before = pa.LAUNCHES
    first = pa.pdist_argmin(x, c, cm)
    second = pa.pdist_argmin(x, c, cm)
    assert pa.LAUNCHES == before + 2
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1].view(torch.int32), second[1].view(torch.int32))


# (x shape, k, weighted): the shapes the k-FED paths launch kmeans_update
# at: the round's local Lloyd steps, the server's Lloyd round (2-D x), a
# serve batch's local_prepare, the serve path's refresh over 1024 fold
# slots x k' = 10, and the routed leg's local_prepare; the server's
# weighted form.
KMEANS_PATH_SHAPES = [((50, 400, 300), 10, False), ((500, 300), 100, False),
                      ((8, 1024, 300), 10, False), ((10240, 300), 100, False),
                      ((64, 64, 128), 4, False), ((500, 300), 100, True)]

# The plan (L, column groups, summing threads, bucketing warps) of each
# path shape on a card of 132 SMs (an H100 SXM), as PERF.md gives them.
KMEANS_PATH_PLANS = [(32, 1, 96, 13), (16, 1, 96, 16), (16, 1, 96, 32),
                     (16, 1, 96, 32), (16, 1, 32, 2), (16, 1, 96, 16)]


def update_inputs(seed, shape, k, case, device, dtype=torch.float32,
                  offset=0):
    """x of ``shape`` (stored in ``dtype``, ``offset`` elements into its
    storage), an assignment in [-1, k) and weights, from a seeded
    generator. ``case``: "mixed" (uniform, with -1); "dominant" (95% of
    the rows in one cluster); "mostly_invalid" (92% at -1); or
    "invalid_entry" (mixed, with batch entry 1, or the only one, all at
    -1)."""
    g = torch.Generator().manual_seed(seed)
    n = shape[-2]
    flat = torch.randn(offset + int(np.prod(shape)), generator=g) * 3
    x = flat.to(device, dtype)[offset:].view(*shape)
    a = torch.randint(-1, k, shape[:-1], generator=g)
    u = torch.rand(shape[:-1], generator=g)
    if case == "dominant":
        a = torch.where(u < 0.95, k // 2, a)
    elif case == "mostly_invalid":
        a = torch.where(u < 0.92, -1, a)
    elif case == "invalid_entry":
        a.view(-1, n)[min(1, a.numel() // n - 1)] = -1
    w = torch.rand(shape[:-1], generator=g) * 3 + 0.5
    return x, a.int().to(device), w.to(device)


def assert_update_close(x, a, k, w, s, c):
    """Sums and counts within chip_smoke.py's update tolerance, 1e-5
    relative + n * 1e-7 * max|x| * max w absolute, of the sums taken in
    float64 and of the plain version's. For one cluster of most of the n
    rows: one f32 sum of hundreds of terms, which the plain version's
    product takes in another order (they differ by about sqrt(n) f32
    roundings of the running sum)."""
    n = x.shape[-2]
    scale = float(x.float().abs().max()) * (1.0 if w is None
                                            else float(w.max()))
    oh = (a.unsqueeze(-1) == torch.arange(k, device=a.device)).double()
    if w is not None:
        oh = oh * w.double().unsqueeze(-1)
    exact = (oh.transpose(-1, -2) @ x.double(), oh.sum(-2))
    for want in (exact, ref.kmeans_update(x, a, k, w)):
        ws, wc = (t.double() for t in want)
        assert bool(((s.double() - ws).abs()
                     <= 1e-5 * ws.abs() + n * 1e-7 * scale).all())
        assert float((c.double() - wc).abs().max()) <= (
            1e-5 * float(wc.abs().max()) + n * 1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k", [((1, 5, 3), 2), ((3, 70, 33), 7),
                                     ((50, 400, 300), 10),
                                     ((2, 3000, 129), 5), ((2, 50, 64), 200)]
                         + [(s, k) for s, k, w in KMEANS_PATH_SHAPES if not w])
@pytest.mark.parametrize("case", ["mixed", "dominant", "mostly_invalid",
                                  "invalid_entry"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_kmeans_update_matches_plain(cuda_device, shape, k, case, dtype):
    """Sums and counts against the plain version, with and without
    weights: every path shape, d not a multiple of 4 (3, 33, 129), k > n
    (empty clusters), one dominant cluster (a list of many segments),
    rows mostly at -1, an all-invalid batch entry (exact zeros), bf16
    x. The dominant cluster's sums are held to assert_update_close."""
    from repro_torch.kernels.kmeans_update import kmeans_update
    x, a, w = update_inputs(sum(shape) + k, shape, k, case, cuda_device,
                            dtype)
    for weights in (None, w):
        s, c = kmeans_update(x, a, k, weights)
        rs, rc = ref.kmeans_update(x, a, k, weights)
        if case == "dominant":
            assert_update_close(x, a, k, weights, s, c)
        else:
            torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(c, rc, rtol=1e-5, atol=1e-4)
        if case == "invalid_entry":
            e = min(1, a.numel() // shape[-2] - 1)
            assert not bool(s.view(-1, k, shape[-1])[e].any())
            assert not bool(c.view(-1, k)[e].any())


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_kmeans_update_unaligned_rows(cuda_device, offset, dtype):
    """x whose base is not aligned to 4 elements takes the element-wise
    loads, and gives the bits of the aligned copy's 4-element loads."""
    from repro_torch.kernels.kmeans_update import kmeans_update
    x, a, w = update_inputs(3, (4, 300, 64), 9, "mixed", cuda_device, dtype,
                            offset)
    if offset:
        assert x.data_ptr() % (4 * x.element_size())
    for weights in (None, w):
        s, c = kmeans_update(x, a, 9, weights)
        rs, rc = ref.kmeans_update(x, a, 9, weights)
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(c, rc, rtol=1e-5, atol=1e-4)
        aligned = kmeans_update(x.clone(), a, 9, weights)
        assert torch.equal(s.view(torch.int32), aligned[0].view(torch.int32))
        assert torch.equal(c.view(torch.int32), aligned[1].view(torch.int32))


def in_order(terms):
    """f32 sum of the rows of ``terms`` one after the other (0 if none)."""
    if len(terms) == 0:
        return np.float32(0)
    return np.cumsum(np.asarray(terms, np.float32), axis=0,
                     dtype=np.float32)[-1]


def sequential_sums(x, a, k, seg_rows, group):
    """Each cluster's rows in point order, summed in f32 one after the
    other within segments of ``seg_rows`` rows; the segments' sums added
    in order within groups of ``group`` segments, then the groups' sums
    in order: the kernel's order of summation, on the CPU."""
    x = x.float().cpu().numpy().reshape(-1, *x.shape[-2:])
    a = a.cpu().numpy().reshape(-1, x.shape[1])
    out = np.zeros((x.shape[0], k, x.shape[2]), np.float32)
    for b in range(x.shape[0]):
        for r in range(k):
            rows = x[b][a[b] == r]
            segs = [in_order(rows[lo:lo + seg_rows])
                    for lo in range(0, len(rows), seg_rows)]
            groups = [in_order(segs[g:g + group])
                      for g in range(0, len(segs), group)]
            out[b, r] = in_order(groups)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,case", [((3, 40, 33), 10, "mixed"),
                                          ((8, 1024, 300), 10, "mixed"),
                                          ((2, 500, 64), 5, "dominant"),
                                          ((1, 10240, 36), 100, "dominant")])
def test_gpu_kmeans_update_sums_in_point_order(cuda_device, shape, k, case):
    """A list of one segment is summed in point order from 0 (the bits
    of a sequential f32 sum, as the first version of the kernel gave); a
    longer list in segments of L rows, added in order within groups of
    segments and then the groups in order (about 77 groups of 8 at the
    last shape): the sums equal that order's bit for bit."""
    from repro_torch.kernels.kmeans_update import kmeans_update, plan
    x, a, _ = update_inputs(k + shape[-1], shape, k, case, cuda_device)
    B = shape[0]
    p = plan(B, shape[1], k, shape[2], False, cuda_device)
    s, _ = kmeans_update(x, a, k)
    want = sequential_sums(x, a, k, p.seg_rows, p.group)
    assert np.array_equal(s.cpu().numpy().view(np.int32),
                          want.reshape(s.shape).view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,weighted", KMEANS_PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_kmeans_update_runs_twice_alike(cuda_device, shape, k, weighted,
                                            dtype):
    """Two calls give the same bits (no float atomics: every sum in an
    order fixed by the shape and the assignment), at every path shape,
    with a dominant cluster (many segments) as well as mixed rows."""
    from repro_torch.kernels.kmeans_update import kmeans_update
    for case in ("mixed", "dominant"):
        x, a, w = update_inputs(k + shape[-1], shape, k, case, cuda_device,
                                dtype)
        w = w if weighted else None
        first = kmeans_update(x, a, k, w)
        second = kmeans_update(x, a, k, w)
        for f, g in zip(first, second):
            assert torch.equal(f.view(torch.int32), g.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape_k,want", zip(KMEANS_PATH_SHAPES,
                                             KMEANS_PATH_PLANS))
def test_gpu_kmeans_update_path_plans(cuda_device, shape_k, want):
    """The plan of every path shape is what the kernels launch: a call
    with the plan's scratch gives the plain version's sums, one byte
    less is refused; the summing grid is items x groups x B with
    items = ceil(n / L) + k; on a card of 132 SMs the plan is the one
    that PERF.md gives."""
    from repro_torch.kernels import kmeans_update as ku
    shape, k, weighted = shape_k
    B = shape[0] if len(shape) == 3 else 1
    n, d = shape[-2:]
    p = ku.plan(B, n, k, d, weighted, cuda_device)
    assert p.items == -(-n // p.seg_rows) + k
    assert p.sum_blocks == p.items * p.groups * B
    assert p.groups * p.sum_threads >= -(-d // 4) and p.sum_threads % 32 == 0
    if p.sms == 132:
        assert (p.seg_rows, p.groups, p.sum_threads, p.bucket_warps) == want
    x, a, w = update_inputs(n + k, shape, k, "mixed", cuda_device)
    w = w if weighted else None
    sums = torch.empty((*shape[:-2], k, d), device=cuda_device)
    counts = torch.empty((*shape[:-2], k), device=cuda_device)
    scratch = torch.empty((p.scratch_bytes,), dtype=torch.uint8,
                          device=cuda_device)
    ku._launch(x, a, k, w, sums, counts, scratch)
    rs, rc = ref.kmeans_update(x, a, k, w)
    torch.testing.assert_close(sums, rs, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(counts, rc, rtol=1e-5, atol=1e-4)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ku._launch(x, a, k, w, sums, counts, scratch[:-1])


@pytest.mark.gpu
def test_gpu_kmeans_update_counts_one_launch_a_call(cuda_device):
    """LAUNCHES grows by one a wrapper call (two kernels each), batched
    or 2-D, with weights or without, and not for an empty output."""
    from repro_torch.kernels import kmeans_update as ku
    x, a, w = update_inputs(1, (3, 70, 33), 7, "mixed", cuda_device)
    before = ku.LAUNCHES
    ku.kmeans_update(x, a, 7)
    ku.kmeans_update(x, a, 7, w)
    ku.kmeans_update(x[0], a[0], 7)
    assert ku.LAUNCHES == before + 3
    ku.kmeans_update(x[:0], a[:0], 7)
    assert ku.LAUNCHES == before + 3


def _clustered_batch(seed, B, n, d, kp, k, distinct=False):
    """Requests drawn around tau centers (the serve path's data), so no
    point sits on a Voronoi boundary at float precision. Centers start at
    the first kp points, or with ``distinct`` at the first point of kp
    different clusters, so that no two centers split one cluster."""
    rng = np.random.default_rng(seed)
    tau = (rng.normal(size=(k, d)) * 10).astype(np.float32)
    lab = rng.integers(0, k, size=(B, n))
    x = (tau[lab] + rng.normal(size=(B, n, d))).astype(np.float32)
    c0 = np.ascontiguousarray(x[:, :kp])
    if distinct:
        for b in range(B):
            _, first = np.unique(lab[b], return_index=True)
            c0[b] = x[b, np.sort(first)[:kp]]
    cm = np.ones((B, kp), bool)
    cm[-1, -1] = False
    pm = np.ones((B, n), bool)
    pm[0, n // 2:] = False
    return tau, x, c0, cm, pm


# Shapes of the split kernel (64 rows a slice):
# - P = 4 with a ragged last slice of 8 rows, request 0's third slice
#   all masked; P = 8 stopped by max_iters;
# - the serve shape, and 64 of its requests: more groups than the card
#   holds at once;
# - k' = 668 at d = 64: the centers and a slice do not fit in shared
#   memory together (the streaming mode, 42 register groups of
#   centers). The centers start in 668 of 1000 clusters, because where
#   two centers split one cluster the points near their boundary take
#   either side under the two versions' rounding; and d stays at 64,
#   because at this data's norms an f32 product summed over 300 columns
#   already rounds the expanded distance by about the whole tolerance;
# - n = 10000: more slices of 64 rows than the card holds at once, so
#   the plan takes slices of 128 rows (streamed).
SPLIT_SHAPES = [(3, 200, 37, 5, 9, 30), (4, 500, 64, 6, 12, 2),
                (8, 1024, 300, 10, 100, 100), (64, 1024, 300, 10, 100, 100),
                (2, 4096, 64, 668, 1000, 100), (2, 10000, 16, 4, 8, 30),
                # The attach leg's coalesced oversized rungs at Table 1's
                # width, right-sized to batches of 1 and 2.
                (1, 4096, 300, 10, 100, 100), (2, 2048, 300, 10, 100, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,kp,k,iters", SOLVE_SHAPES + SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gpu_solve_attach_matches_plain(cuda_device, B, n, d, kp, k, iters,
                                        dtype):
    from repro_torch.kernels.solve_attach import plan
    if n < 200:
        tau, x, c0, cm, pm = request_batch(n * 13 + k, B, n, d, kp, k)
    else:
        tau, x, c0, cm, pm = _clustered_batch(n * 13 + k, B, n, d, kp, k,
                                              distinct=kp > 100)
    args = [T(v).to(cuda_device) for v in (x, c0, tau, cm, pm)]
    pl = plan(n, kp, d, ref.store_dtype(dtype), cuda_device)
    assert pl.rows == (128 if n == 10000 else 64)
    assert pl.resident == (pl.rows == 64 and kp * d < 20000)
    assert pl.slices == -(-n // pl.rows) <= pl.per_sm * pl.sms
    if B == 64:
        assert pl.groups < B   # a group serves several requests in turn
    got = ops.solve_attach(*args, max_iters=iters, dtype=dtype)
    want = ref.solve_attach(*args, max_iters=iters, dtype=dtype)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)
    xs = args[0].to(ref.store_dtype(dtype)).float()
    a, _ = ref.assign_argmin(xs, want[2], args[3])
    assert_min_dist(got[1].cpu().numpy(), want[1].cpu().numpy(),
                    xs.cpu().numpy(), want[2].cpu().numpy(),
                    a.cpu().numpy())


def _solve_outputs_equal(got, want):
    """Bit for bit: labels, min-dists, centers and center labels."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gpu_solve_attach_batch_independent(cuda_device, dtype):
    """Each request of a serve batch (8 x 1024 x 300, k'=10, k=100)
    alone gives the bits it gives inside the batch: its P = 16 blocks
    and their order of summation depend on its shape only."""
    tau, x, c0, cm, pm = _clustered_batch(7, 8, 1024, 300, 10, 100)
    args = [T(v).to(cuda_device) for v in (x, c0, tau, cm, pm)]
    whole = ops.solve_attach(*args, max_iters=100, dtype=dtype)
    for b in range(8):
        one = ops.solve_attach(*(a[b:b + 1] for a in args[:2]), args[2],
                               *(a[b:b + 1] for a in args[3:]),
                               max_iters=100, dtype=dtype)
        assert _solve_outputs_equal(one, [w[b:b + 1] for w in whole]), b


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d", [(8, 1024, 300), (64, 64, 128),
                                   (2, 300, 2048)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gpu_solve_attach_runs_twice_alike(cuda_device, B, n, d, dtype):
    """Two calls give the same bits (no float atomics; the slices'
    partials summed in slice order), and each counts one launch."""
    from repro_torch.kernels import solve_attach as sa
    tau, x, c0, cm, pm = _clustered_batch(n + d, B, n, d, 10, 40)
    args = [T(v).to(cuda_device) for v in (x, c0, tau, cm, pm)]
    before = sa.LAUNCHES
    first = ops.solve_attach(*args, max_iters=100, dtype=dtype)
    second = ops.solve_attach(*args, max_iters=100, dtype=dtype)
    assert sa.LAUNCHES == before + 2
    assert _solve_outputs_equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,S", MOE_SHAPES + [
    (64, 8192, 80), (64, 64, 80), (3, 40001, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mixed", "all_invalid", "unaligned"])
def test_gpu_moe_dispatch_matches_plain(cuda_device, T, d, S, dtype, case):
    """Bit for bit: 16-byte copies, the ragged tail, rows longer than
    one block's chunk, and x starting off a 16-byte boundary."""
    from repro_torch.kernels import moe_dispatch as md
    x, src, valid, _, _ = moe_inputs(T + d, T, d, S)
    if case == "all_invalid":
        valid[:] = False
    tx = torch.as_tensor(x).to(cuda_device, dtype)
    if case == "unaligned":
        buf = torch.zeros(T * d + 1, dtype=dtype, device=cuda_device)
        buf[1:] = tx.reshape(-1)
        tx = buf[1:].view(T, d)
    ts, tv = torch.as_tensor(src).to(cuda_device), torch.as_tensor(valid).to(cuda_device)
    before = md.LAUNCHES
    got = md.moe_dispatch(tx, ts, tv)
    assert md.LAUNCHES == before + 1
    want = ref.moe_dispatch(tx, ts, tv)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,S", COMBINE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["mixed", "unaligned", "inf_row"])
def test_gpu_moe_combine_matches_plain(cuda_device, T, d, S, dtype, top_k,
                                       case):
    """Bit for bit against the plain version (top_k <= 2) and the
    sequential sum (any top_k), on the vector path (d a multiple of 16
    bytes) and the scalar one, from a ybuf that starts off a 16-byte
    boundary (the scalar path), with a row of inf named only by zero
    gates (NaN, as in the plain version); two calls give the same bits
    and count two launches."""
    from repro_torch.kernels import moe_combine as mc
    _, _, _, ybuf, (slot, gates) = moe_inputs(T * top_k + d, T, d, S,
                                              top_k=top_k)
    if case == "inf_row":
        ybuf, slot, gates, nan_tokens = with_inf_row(ybuf, slot, gates,
                                                     top_k)
    ty = torch.as_tensor(ybuf).to(cuda_device, dtype)
    if case == "unaligned":
        buf = torch.zeros(S * d + 1, dtype=dtype, device=cuda_device)
        buf[1:] = ty.reshape(-1)
        ty = buf[1:].view(S, d)
    tsl, tg = torch.as_tensor(slot).to(cuda_device), torch.as_tensor(gates).to(cuda_device)
    before = mc.LAUNCHES
    got = mc.moe_combine(ty, tsl, tg, top_k)
    again = mc.moe_combine(ty, tsl, tg, top_k)
    assert mc.LAUNCHES == before + 2
    want = ref.moe_combine(ty, tsl, tg, top_k)
    seq = sequential_combine(ty, tsl, tg, top_k)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (T, d)
    assert_same_bits(got, again)
    assert_same_bits(got, seq)
    if top_k <= 2:
        assert_same_bits(got, want)
    else:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert_combine_close(got.masked_fill(nan, 0), want.masked_fill(nan, 0),
                             ty.float().nan_to_num(0, 0, 0), tsl, tg, top_k)
    if case == "inf_row":
        nan_rows = torch.isnan(got).all(dim=1).cpu().numpy()
        assert np.array_equal(np.nonzero(nan_rows)[0], nan_tokens)


# (T, d, top_k, dtype) of each path's combine -> the plan's fields but
# the SMs, on a card of 132 SMs: routed (80, 128) f32 top_k=1, the
# Mixtral prefill (40960, 4096) bf16 and decode step (16, 4096) bf16 at
# top_k=2 (4 tokens: rows cut into 16 chunks).
COMBINE_PATH_PLANS = [
    ((64, 128, 1, torch.float32), (4, 32, 1, 32, 1, 1, 1, 32, 64)),
    ((16384, 4096, 2, torch.bfloat16), (8, 512, 1, 512, 1, 2, 1, 512, 16384)),
    ((4, 4096, 2, torch.bfloat16), (8, 512, 16, 32, 1, 2, 1, 32, 64))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,want", COMBINE_PATH_PLANS)
def test_gpu_moe_combine_path_plans(cuda_device, shape, want):
    """The plan at each path's shape on an H100 (132 SMs): a 16-byte
    piece a thread, one token of 512 threads a block at the prefill, 64
    one-warp blocks at the decode step and the routed step; a row that
    is not a multiple of the piece takes the scalar path, in whole
    warps."""
    from repro_torch.kernels import moe_combine as mc
    T_, d, top_k, dtype = shape
    p = mc.plan(T_, d, top_k, dtype, cuda_device)
    assert p.sms == 132, "the plans are an H100's"
    assert tuple(p)[:-1] == want
    scalar = mc.plan(T_, d + 1, top_k, dtype, cuda_device)
    assert scalar.columns == 1 and scalar.pieces == d + 1
    assert scalar.chunk % 32 == 0 and scalar.chunks * scalar.chunk > d


@pytest.mark.gpu
@pytest.mark.parametrize("heads,arch", [("qwen1.5-0.5b", "transformer"),
                                        ("nemotron-4-15b", "ffn")])
def test_gpu_routed_step_matches_cpu(cuda_device, heads, arch):
    """One routed step on the card (both routing kernels) against the
    CPU run of the plain versions on the same inputs, heads and draws;
    the all-to-one half of the batch overflows its queue."""
    from repro_torch.fed.plane import _make_routed_step
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.models.heads import init_heads, tree_map
    from repro_torch.utils.prng import GumbelSource
    k, d, B, n = 8, 32, 16, 48
    cfg = StreamConfig(k=k, k_prime=2, d=d, capacity=64, batch_size=B,
                       bucket_sizes=(n,), heads=heads, head_arch=arch)
    rng = np.random.default_rng(0)
    tau = (rng.normal(size=(k, d)) * 20).astype(np.float32)
    owner = np.where(np.arange(B) < B // 2, np.arange(B) % k, 0)
    data = (rng.normal(size=(B, n, d)) + tau[owner][:, None]).astype(
        np.float32)
    pmask = np.ones((B, n), bool)
    pmask[3, n // 2:] = False
    kv = np.full((B,), 2, np.int32)
    params = init_heads(torch.Generator().manual_seed(1), k,
                        cfg.head_spec(), device="cpu")
    g = GumbelSource(3).draw(range(B), 2, n, "cpu")
    step = _make_routed_step(cfg)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        args = [torch.as_tensor(a).to(dev) for a in (tau, g, data, pmask, kv)]
        p = tree_map(lambda a: a.to(dev), params)
        ops.reset_launch_counts()
        out = step(args[0], p, *args[1:])
        outs.append([o.cpu() for o in out])
        if dev.type == "cuda":
            counts = ops.launch_counts()
            assert counts["moe_dispatch"] == 2 and counts["moe_combine"] == 1
    got, want = outs
    for i in (0, 2, 5, 6):      # labels, center mask, cluster, kept
        assert torch.equal(got[i], want[i]), i
    assert not bool(want[6].all())   # the one-cluster half overflowed
    scale = float(want[4].abs().max())
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-5 * scale)
    assert bool((got[4][~want[6]] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("heads,arch", [("qwen1.5-0.5b", "transformer"),
                                        ("linear", "ffn")])
def test_gpu_allk_step_matches_routed_on_kept(cuda_device, heads, arch):
    """The routed bench's baseline (every cluster's head over the whole
    batch) on the card against the routed step on the same inputs: the
    label body and the votes equal, every request kept, and the routed
    step's kept requests' predictions within rtol / atol 1e-6; the
    baseline launches no routing kernel."""
    from repro_torch.fed.plane import _make_allk_step, _make_routed_step
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.models.heads import init_heads
    from repro_torch.utils.prng import GumbelSource
    k, d, B, n = 8, 32, 16, 48
    cfg = StreamConfig(k=k, k_prime=2, d=d, capacity=64, batch_size=B,
                       bucket_sizes=(n,), heads=heads, head_arch=arch)
    rng = np.random.default_rng(1)
    tau = (rng.normal(size=(k, d)) * 20).astype(np.float32)
    owner = np.where(np.arange(B) < B // 2, np.arange(B) % k, 0)
    data = (rng.normal(size=(B, n, d)) + tau[owner][:, None]).astype(
        np.float32)
    pmask = np.ones((B, n), bool)
    pmask[3, n // 2:] = False
    kv = np.full((B,), 2, np.int32)
    params = init_heads(torch.Generator().manual_seed(1), k,
                        cfg.head_spec(), device=cuda_device)
    g = GumbelSource(3).draw(range(B), 2, n, cuda_device)
    args = [torch.as_tensor(a).to(cuda_device)
            for a in (tau, data, pmask, kv)]
    args = (args[0], params, g, *args[1:])
    routed = _make_routed_step(cfg)(*args)
    ops.reset_launch_counts()
    allk = _make_allk_step(cfg)(*args)
    counts = ops.launch_counts()
    assert counts["moe_dispatch"] == counts["moe_combine"] == 0
    assert counts["solve_attach"] == 1
    for i in range(4):
        assert torch.equal(allk[i], routed[i]), i
    assert torch.equal(allk[5], routed[5]) and bool(allk[6].all())
    kept = routed[6]
    assert bool(kept.any()) and not bool(kept.all())
    torch.testing.assert_close(allk[4][kept], routed[4][kept], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_gpu_flops_by_dtype_equals_meta(cuda_device, arch, mode):
    """launch.flops counts a step run on the card (its kernels, the
    backward's on autograd's device thread included) as the same step on
    the meta device: the same matmul flops by dtype."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.flops import Counter
    cfg = get_config(arch, reduced=True).replace(remat=True, microbatch=2)
    shape = InputShape(mode, 32, 4, mode)
    counts = []
    for gen in (torch.Generator(device=cuda_device).manual_seed(0), None):
        step, args, _ = build_step(cfg, shape, None, gen)
        with Counter() as c:
            step(*args)
        counts.append(c)
    card, meta = counts
    assert card.flops == meta.flops and card.flops["bf16"] > 0
    assert card.calls == meta.calls


@pytest.mark.gpu
@pytest.mark.parametrize("W", [64, 200, 4096])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", ["scattered", "prefix"])
def test_gpu_swa_decode_matches_plain(cuda_device, W, g, dh, dtype, ring):
    from repro_torch.kernels import swa_decode as sw
    kvh = 2
    arrays = swa_inputs(W + g + dh, 3, g * kvh, kvh, dh, W, ring)
    q, kw, vw = (torch.as_tensor(a).to(cuda_device, dtype)
                 for a in arrays[:3])
    bias = torch.as_tensor(arrays[3]).to(cuda_device)
    before = sw.LAUNCHES
    got = sw.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    assert sw.LAUNCHES == before + 1
    want = ref.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert_swa_close(got, want, dtype)


@pytest.mark.gpu
def test_gpu_swa_decode_leg_shape_and_refusals(cuda_device):
    """The decode leg's shape (4 sequences, 32 heads over 8 kv heads of
    128, W=4096, bf16), an odd head width (the scalar load path), and
    the operands the kernel refuses."""
    from repro_torch.kernels import swa_decode as sw
    for (b, h, kvh, dh, W) in ((4, 32, 8, 128, 4096), (2, 6, 3, 33, 77)):
        arrays = swa_inputs(b * W, b, h, kvh, dh, W, "scattered")
        for dtype in (torch.bfloat16, torch.float32):
            q, kw, vw = (torch.as_tensor(a).to(cuda_device, dtype)
                         for a in arrays[:3])
            bias = torch.as_tensor(arrays[3]).to(cuda_device)
            got = sw.swa_decode_attention(q, kw, vw, bias, 0.125)
            want = ref.swa_decode_attention(q, kw, vw, bias, 0.125)
            torch.cuda.synchronize()
            assert_swa_close(got, want, dtype)
    with pytest.raises(ValueError, match="do not match"):
        sw.swa_decode_attention(q, kw.to(torch.bfloat16), vw, bias, 1.0)
    with pytest.raises(ValueError, match="beyond the kernel"):
        big = torch.zeros((1, 2, 512), device=cuda_device)
        sw.swa_decode_attention(big, torch.zeros((1, 4, 1, 512),
                                                 device=cuda_device),
                                torch.zeros((1, 4, 1, 512),
                                            device=cuda_device),
                                torch.zeros((1, 4), device=cuda_device), 1.0)


def swa_chunk_bias(seed, b, W, S):
    """A ring's bias for the split kernel's chunks [s W / S, (s+1) W / S):
    row 0 scattered with its middle chunk (s = S // 2) all masked and
    keys in the chunks either side; the middle rows scattered; the last
    row (b >= 3) all masked."""
    rng = np.random.default_rng(seed)
    valid = rng.random((b, W)) < 0.6
    valid[:, 0] = True
    if S > 1:
        lo, hi = (S // 2) * W // S, (S // 2 + 1) * W // S
        valid[0, lo:hi] = False
        valid[0, lo - 1] = True
        if hi < W:
            valid[0, hi] = True
    if b >= 3:
        valid[-1] = False
    return np.where(valid, 0.0, -1e30).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 63, 65, 257, 4095, 4097, 8192])
@pytest.mark.parametrize("g", [4, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_swa_decode_split_windows(cuda_device, W, g, dtype):
    """Windows that make the chunks ragged or single (S = 1 below 128
    keys, S > 1 above), a row whose middle chunk is all masked between
    chunks that hold keys, and an all-masked row; g=12 takes two blocks
    of query rows. Two calls give the same bits, and each counts one
    launch."""
    from repro_torch.kernels import swa_decode as sw
    b, kvh, dh = 3, 2, 128
    S = sw.splits(b, g * kvh, W, kvh, cuda_device)
    assert (S == 1) == (W < 128)
    assert all(W * (s + 1) // S - W * s // S >= min(W, 64)
               for s in range(S))
    q, kw, vw, _ = swa_inputs(W + g, b, g * kvh, kvh, dh, W, "prefix")
    q, kw, vw = (torch.as_tensor(a).to(cuda_device, dtype)
                 for a in (q, kw, vw))
    bias = torch.as_tensor(swa_chunk_bias(W, b, W, S)).to(cuda_device)
    before = sw.LAUNCHES
    got = sw.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    again = sw.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    assert sw.LAUNCHES == before + 2
    want = ref.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    assert_swa_close(got, want, dtype)
    # The all-masked row is the plain average of V over the window.
    mean = vw[-1].float().mean(dim=0).repeat_interleave(g, dim=0)
    assert_swa_close(got[-1], mean, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,dh,W", [
    (2, 6, 2, 24, 300),     # g=3 in a block of 4 rows; idle lanes
    (2, 24, 2, 64, 700),    # g=12: two blocks of rows
    (1, 4, 2, 256, 1000),   # f32: two 16-byte pieces per lane
    (2, 3, 1, 7, 130),      # scalar path
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_swa_decode_split_shapes(cuda_device, b, h, kvh, dh, W, dtype):
    from repro_torch.kernels import swa_decode as sw
    q, kw, vw, bias = swa_inputs(dh + W, b, h, kvh, dh, W, "scattered")
    q, kw, vw = (torch.as_tensor(a).to(cuda_device, dtype)
                 for a in (q, kw, vw))
    bias = torch.as_tensor(bias).to(cuda_device)
    got = sw.swa_decode_attention(q, kw, vw, bias, 0.3)
    want = ref.swa_decode_attention(q, kw, vw, bias, 0.3)
    torch.cuda.synchronize()
    assert_swa_close(got, want, dtype)


# The context-parallel ring decode (b, h, kvh, dh, W, ranks): each rank's
# block of W / ranks slots through the partial entry point, the ranks'
# chunk states merged by the combine entry point. The cp2 leg's rank
# shape (Mistral-NeMo's 32 heads over 8 kv heads of 128, 2048 slots a
# rank), 4 ranks, a ragged chunking and the scalar load path (dh = 33).
CP_SHAPES = [(1, 32, 8, 128, 4096, 2), (1, 32, 8, 128, 4096, 4),
             (3, 8, 2, 64, 600, 2), (2, 6, 3, 33, 78, 2),
             (2, 12, 2, 128, 300, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,dh,W,R", CP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_swa_cp_blocks_merge_to_one_launch(cuda_device, b, h, kvh, dh,
                                               W, R, dtype):
    """R ranks' blocks of the window, each through swa_decode_partial
    (``ranks=R``: at most 32 / R chunks), the states side by side rank
    after rank and merged by swa_combine: the bits of one partial launch
    over the whole window with R x that many chunks and its combine (rank
    r's chunk j spans that launch's chunk r S + j), and of
    swa_decode_attention where the launcher picks that split; within
    the plain version's tolerance; each rank's states within 2e-5 of
    ref.swa_decode_partial's at the same chunks (row 0's first block
    all masked: m = -1e30 on every chunk); one launch counted a call."""
    from repro_torch.kernels import swa_decode as sw
    q, kw, vw, bias = swa_inputs(W * R + dh, b, h, kvh, dh, W, "scattered")
    n = W // R
    bias[0, :n] = -1e30
    bias[0, n] = 0.0
    q, kw, vw = (torch.as_tensor(a).to(cuda_device, dtype)
                 for a in (q, kw, vw))
    bias = torch.as_tensor(bias).to(cuda_device)
    scale = 1.0 / np.sqrt(dh)
    p0, c0 = sw.PARTIAL.LAUNCHES, sw.COMBINE.LAUNCHES
    blocks = [(kw[:, r * n:(r + 1) * n].contiguous(),
               vw[:, r * n:(r + 1) * n].contiguous(),
               bias[:, r * n:(r + 1) * n].contiguous()) for r in range(R)]
    parts = [sw.swa_decode_partial(q, k, v, bb, scale, ranks=R)
             for k, v, bb in blocks]
    S = parts[0].shape[1]
    assert 1 <= S <= 32 // R and all(p.shape == (b * h, S, dh + 2)
                                     for p in parts)
    got = sw.swa_combine(torch.cat(parts, dim=1), dtype).reshape(b, h, dh)
    assert (sw.PARTIAL.LAUNCHES, sw.COMBINE.LAUNCHES) == (p0 + R, c0 + 1)
    one = sw.swa_combine(sw.swa_decode_partial(q, kw, vw, bias, scale,
                                               chunks=R * S), dtype)
    assert torch.equal(got, one.reshape(b, h, dh))
    if sw.splits(b, h, W, kvh, cuda_device) == R * S:
        assert torch.equal(got, sw.swa_decode_attention(q, kw, vw, bias,
                                                        scale))
    want = ref.swa_decode_attention(q, kw, vw, bias, scale)
    torch.cuda.synchronize()
    assert_swa_close(got, want, dtype)
    for r, (k, v, bb) in enumerate(blocks):
        a = parts[r].cpu()
        e = ref.swa_decode_partial(q, k, v, bb, scale, splits=S).cpu()
        live = e[..., 0] > -1e29           # chunks that hold a key
        assert torch.equal(a[..., 0][~live], e[..., 0][~live]), r
        for x, y in ((a[..., 0][live], e[..., 0][live]),
                     (a[..., 1], e[..., 1]), (a[..., 2:], e[..., 2:])):
            assert x.numel() == 0 or float((x - y).abs().max()) <= (
                2e-5 * float(y.abs().max())), r
    assert (parts[0].reshape(b, h, S, -1)[0, :, :, 0] == -1e30).all()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,S,dh", [(64, 2, 128), (7, 32, 33),
                                       (5, 1, 256), (32, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_swa_combine_matches_merge_states(cuda_device, rows, S, dh,
                                              dtype):
    """swa_combine over gathered chunk states against ref.merge_states:
    states of masked keys only (m = -1e30) beside ones that hold keys,
    a row whose every state is masked (the average of V over every
    slot), within 2e-5 (f32) or 2e-2 (bf16) of the largest output."""
    from repro_torch.kernels import swa_decode as sw
    rng = np.random.default_rng(rows * S + dh)
    m = (rng.normal(size=(rows, S)) * 4).astype(np.float32)
    ln = rng.integers(1, 50, size=(rows, S)).astype(np.float32)
    l = ln * rng.random((rows, S)).astype(np.float32) + 1
    acc = rng.normal(size=(rows, S, dh)).astype(np.float32) * l[..., None]
    masked = rng.random((rows, S)) < 0.3
    masked[-1] = True
    m[masked] = -1e30
    l[masked] = ln[masked]
    part = torch.as_tensor(np.concatenate([m[..., None], l[..., None], acc],
                                          axis=-1)).to(cuda_device)
    got = sw.swa_combine(part, dtype)
    want = ref.merge_states(part)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rows, dh)
    assert_swa_close(got, want, dtype)
    mean = part[-1, :, 2:].sum(0) / part[-1, :, 1].sum()
    assert_swa_close(got[-1], mean, dtype)


@pytest.mark.gpu
def test_gpu_swa_cp_refusals(cuda_device):
    """What the partial and combine entry points refuse: more chunks
    than 32 over the ranks or than keys, a combine of more than 32
    states, a state wider than 256, a CPU tensor."""
    from repro_torch.kernels import swa_decode as sw
    q = torch.zeros((1, 4, 64), device=cuda_device)
    kw = torch.zeros((1, 64, 2, 64), device=cuda_device)
    bias = torch.zeros((1, 64), device=cuda_device)
    with pytest.raises(ValueError, match="chunks"):
        sw.swa_decode_partial(q, kw, kw, bias, 1.0, ranks=4, chunks=9)
    with pytest.raises(ValueError, match="chunks"):
        sw.swa_decode_partial(q, kw, kw, bias, 1.0, chunks=65)
    with pytest.raises(ValueError, match="ranks"):
        sw.swa_decode_partial(q, kw, kw, bias, 1.0, ranks=33)
    with pytest.raises(ValueError, match="chunk states"):
        sw.swa_combine(torch.zeros((2, 33, 66), device=cuda_device),
                       torch.float32)
    with pytest.raises(ValueError, match="chunk states"):
        sw.swa_combine(torch.zeros((2, 2, 259), device=cuda_device),
                       torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sw.swa_combine(torch.zeros((2, 2, 66)), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("T,cf", [(16, 1.5), (512, 1.5), (512, 0.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_local_moe_matches_cpu(cuda_device, T, cf, dtype):
    """The MoE layer of reduced Mixtral on the card (both routing
    kernels) against its CPU run. In f32 the routing (experts, their
    order and the capacity drops) is exact and the output within 1e-5
    of its largest magnitude. In bf16 the router's logits are rounded
    to bf16 after products summed in another order (cuBLAS may also
    reduce in bf16), so tokens whose logits are tied within that
    difference may route the other way: each token's expert set is
    exact wherever its k-th and (k+1)-th logits lie more than twice the
    largest logit difference apart, and the output is within 2e-2 on
    every token routed and kept alike on both devices."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x7b", reduced=True)
    m = dataclasses.replace(cfg.moe, capacity_factor=cf)
    gen = torch.Generator().manual_seed(T)
    p = moe.init_moe(gen, cfg, dtype)
    x = torch.randn(T, cfg.d_model, generator=gen).to(dtype)
    C = moe._capacity(T, m)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        pd, xd = {k: v.to(dev) for k, v in p.items()}, x.to(dev)
        ops.reset_launch_counts()
        y, aux = moe._local_moe(pd, xd, m)
        if dev.type == "cuda":
            counts = ops.launch_counts()
            assert counts["moe_dispatch"] == 1 and counts["moe_combine"] == 1
        ids = moe._route(pd["router"], xd, m)[0]
        keep = moe._plan(ids, m, C)[4].view(T, m.top_k)
        outs.append((y.float().cpu(), float(aux), ids.cpu(), keep.cpu(),
                     (xd @ pd["router"]).float().cpu()))
    (y1, a1, i1, k1, l1), (y0, a0, i0, k0, l0) = outs
    if dtype == torch.float32:
        assert torch.equal(i1, i0) and torch.equal(k1, k0)
        same = torch.ones(T, dtype=torch.bool)
        tol, tol_aux = 1e-5, 1e-5
    else:
        # The same expert set, its keep flags in expert order.
        o1, o0 = i1.argsort(-1), i0.argsort(-1)
        same_set = (i1.gather(-1, o1) == i0.gather(-1, o0)).all(-1)
        same = same_set & (k1.gather(-1, o1) == k0.gather(-1, o0)).all(-1)
        top = torch.sort(l0, dim=-1, descending=True).values
        clear = (top[:, m.top_k - 1] - top[:, m.top_k]
                 > 2 * float((l1 - l0).abs().max()))
        assert bool(same_set[clear].all())
        assert float(same.float().mean()) > 0.75
        tol, tol_aux = 2e-2, 1e-2
    assert float((y1 - y0)[same].abs().max()) <= tol * float(y0.abs().max())
    assert abs(a1 - a0) <= tol_aux * abs(a0)


@pytest.mark.gpu
def test_gpu_generate_matches_cpu(cuda_device):
    """Reduced Mixtral (f32, W=64) through launch.serve.generate on the
    card and on the CPU from the same parameters: 64-token prompts, 8
    steps over the ring cache; tokens exact, logits within 1e-4 of their
    largest magnitude, one swa_decode launch per layer and step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    cfg = get_config("mixtral-8x7b", reduced=True).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64)), dtype=torch.int32)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        ops.reset_launch_counts()
        stats = {}
        p = tree_map(lambda a: a.to(dev), params)
        out = generate(model, p, {"tokens": toks}, steps=8, stats=stats)
        runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                             for lg in stats["logits"]])))
        if dev.type == "cuda":
            assert ops.launch_counts()["swa_decode"] == 8 * cfg.n_layers
    (t1, l1), (t0, l0) = runs
    assert torch.equal(t1, t0)
    assert float((l1 - l0).abs().max()) <= 1e-4 * float(l0.abs().max())


def _small_serving(seed=5):
    from repro_torch.data.gaussian import late_device_stream, structured_devices
    from repro_torch.fed.api import FederationPlan
    fm = structured_devices(seed, k=12, d=24, k_prime=3, m0=2,
                            n_per_comp_dev=12, sep=30.0)
    reqs = late_device_stream(fm.means, 3, 12, 6, n_range=(10, 60))
    plan = FederationPlan(k=12, k_prime=3, d=24, device="cpu", batch_size=4,
                          bucket_sizes=(32, 64), refresh_every=4)
    return fm, [r[0] for r in reqs], [r[2] for r in reqs], plan


@pytest.mark.gpu
def test_gpu_save_restore_serves_like_the_live_session(cuda_device,
                                                       tmp_path):
    """Serve, save and restore on the card: the restored session serves
    the rest with the labels, tau versions and fold state of the
    session that kept serving, bit for bit."""
    from repro_torch.fed.api import Session
    fm, datas, kvs, plan = _small_serving()
    live = Session(plan, seed=2, device=cuda_device)
    live.run(7, fm.data)
    live.serve(datas[:6], kvs[:6])
    path = live.save(str(tmp_path / "card"))
    restored = Session.restore(path, plan, device=cuda_device)
    assert all(a.is_cuda for a in restored.service.state)
    ops.reset_launch_counts()
    got = restored.serve_versioned(datas[6:], kvs[6:])
    assert ops.launch_counts()["solve_attach"] > 0
    want = live.serve_versioned(datas[6:], kvs[6:])
    for (g, gv), (w, wv) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert gv == wv
    for a, b in zip(restored.service.state, live.service.state):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [40, 200, 1500])
def test_gpu_request_alone_equals_it_in_a_batch_of_8(cuda_device, n):
    """Autoscale's premise on the card: a request that latency
    autoscaling serves alone, in a batch of 1, gets the labels it gets
    inside a batch of 8 (autoscale off), bit for bit, for 8 requests of
    n to n + 50 points padded to one rung of n + 50 (2 to 25 slices of
    the serve step's kernel)."""
    from repro_torch.data.gaussian import late_device_stream
    from repro_torch.fed.api import Session
    fm, _, _, plan = _small_serving()
    reqs = late_device_stream(fm.means, 3, 8, 7, n_range=(n, n + 50))
    plan = plan.with_options(batch_size=8, refresh_every=0,
                             bucket_sizes=(n + 50,))
    batched = Session(plan, seed=2, device=cuda_device)
    rr = batched.run(7, fm.data).detail
    ops.reset_launch_counts()
    want = batched.serve_versioned([r[0] for r in reqs],
                                   [r[2] for r in reqs])
    assert ops.launch_counts()["solve_attach"] == 1
    alone = Session.from_round(plan.with_options(autoscale="latency"), rr,
                               seed=2, device=cuda_device)
    for (data, _, kv), (w, wv) in zip(reqs, want):
        (g, gv), = alone.serve_versioned([data], [kv])
        assert alone.service.autoscaler.decision.batch_size == 1
        np.testing.assert_array_equal(g, w)
        assert gv == wv
    assert ops.launch_counts()["solve_attach"] == 1 + len(reqs)


@pytest.mark.gpu
def test_gpu_cpu_archive_restores_on_the_card(cuda_device, tmp_path):
    """An archive written on the CPU restores on the card with the same
    state, and serves the CPU session's labels and tau versions; the
    card's archive restores on the CPU."""
    from repro_torch.fed.api import Session
    fm, datas, kvs, plan = _small_serving(6)
    cpu = Session(plan, seed=2)
    cpu.run(7, fm.data)
    cpu.serve(datas[:6], kvs[:6])
    card = Session.restore(cpu.save(str(tmp_path / "cpu")), plan,
                           device=cuda_device)
    for a, b in zip(card.service.state, cpu.service.state):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    back = Session.restore(card.save(str(tmp_path / "card")), plan)
    for a, b in zip(back.service.state, cpu.service.state):
        assert a.device.type == "cpu" and torch.equal(a, b)
    got = card.serve_versioned(datas[6:], kvs[6:])
    want = cpu.serve_versioned(datas[6:], kvs[6:])
    for (g, gv), (w, wv) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert gv == wv


@pytest.mark.gpu
@pytest.mark.parametrize("kp", [1, 2])
def test_gpu_kfed_personalize_matches_cpu(cuda_device, kp):
    """k-FED + per-cluster FedAvg on the card (the clustering through
    pdist_argmin and kmeans_update) against the CPU run: assignments
    exact, models within atol 2e-5 + rtol 1e-4 (f32 products summed in
    another order)."""
    from repro_torch.data.synthetic_tasks import rotation_tasks
    from repro_torch.fed.fedavg import FedAvgConfig
    from repro_torch.fed.personalize import kfed_personalize
    from repro_torch.models.mlp import init_mlp, mlp_loss
    data = rotation_tasks(np.random.default_rng(kp), Z=16, n_per_dev=12,
                          d=6, k=4, k_prime=kp)
    feats = np.stack([np.stack([data.x[z, idx].mean(0) for idx in
                                np.array_split(np.arange(12), kp)])
                      for z in range(16)])
    cfg = FedAvgConfig(lr=0.1, local_epochs=2, rounds=2)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        dd = {"x": T(data.x, device=dev), "y": T(data.y, device=dev),
              "mask": T(data.point_mask, device=dev)}
        init = init_mlp(torch.Generator().manual_seed(0), 6, 16, 10,
                        device=dev)
        ops.reset_launch_counts()
        models, assign, _ = kfed_personalize(
            2, mlp_loss, init, dd, T(feats, device=dev), 4, cfg,
            k_prime=kp, point_mask=dd["mask"], per_chunk=kp > 1)
        if dev.type == "cuda":
            counts = ops.launch_counts()
            assert counts["pdist_argmin"] > 0 and counts["kmeans_update"] > 0
        outs.append((assign.cpu(), {k: v.cpu() for k, v in models.items()}))
    (a1, m1), (a0, m0) = outs
    assert torch.equal(a1, a0)
    for name in m0:
        torch.testing.assert_close(m1[name], m0[name], rtol=1e-4, atol=2e-5)


@pytest.mark.gpu
def test_gpu_one_rank_nccl_round_equals_simulated(cuda_device, tmp_path):
    """A one-rank NCCL world runs the real collectives: the replicated
    and sharded rounds give the simulated round's labels, the replicated
    one its tau bit for bit and the sharded one within 1e-4 of its
    largest entry."""
    import torch.distributed as dist

    from repro_torch.data.gaussian import structured_devices
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.utils.mesh import make_mesh
    fm = structured_devices(0, k=16, d=24, k_prime=4, m0=4,
                            n_per_comp_dev=20, sep=60.0)
    sim = Session(FederationPlan(k=16, k_prime=4, d=24)).run(1, fm.data)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), backend="nccl")
        for topology in ("replicated", "sharded"):
            out = Session(FederationPlan(k=16, k_prime=4, d=24,
                                         topology=topology),
                          mesh=mesh).run(1, fm.data)
            assert torch.equal(out.labels, sim.labels), topology
            if topology == "replicated":
                assert torch.equal(out.tau_centers, sim.tau_centers)
            want = sim.tau_centers.abs().max().item()
            assert (out.tau_centers - sim.tau_centers).abs().max().item() \
                <= 1e-4 * want
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_gpu_two_rank_gloo_plane_equals_single_process(cuda_device,
                                                       tmp_path):
    """Two gloo ranks share the card (collectives staged through the
    host): the sharded plane serves the labels, tau versions and fold
    state of one process serving alone, bit for bit, on both ranks."""
    import _torch_mesh_ranks as R
    from repro_torch.data.gaussian import (late_device_stream,
                                           structured_devices)
    from repro_torch.fed.api import FederationPlan, Session
    fm = structured_devices(0, k=16, d=24, k_prime=4, m0=4,
                            n_per_comp_dev=25, sep=60.0)
    plan = dict(k=16, k_prime=4, d=24, capacity=256, batch_size=8,
                bucket_sizes=(32, 64, 128), refresh_every=5,
                refresh="async")
    rr = Session(FederationPlan(**plan)).run(1, fm.data).detail
    stream = late_device_stream(fm.means, 4, 13, 5, n_range=(10, 120))
    reqs, kvs = [r[0] for r in stream], [r[2] for r in stream]
    single = Session.from_round(FederationPlan(**plan), rr)
    want = single.serve_versioned(reqs, kvs)
    want += single.serve_versioned(reqs[:4], kvs[:4])
    res = R.spawn(2, str(tmp_path), {"plane": dict(
        plan=plan, round=R._to(rr, "cpu"), reqs=reqs, kvs=kvs,
        device="cuda")})
    for r in res:
        got = r["plane"]
        assert got["serve_shards"] == 2
        for (lbl, ver), (w, wv) in zip(got["served"], want):
            np.testing.assert_array_equal(lbl, w)
            assert ver == wv
        for x, y in zip(got["state"], single.service.state):
            np.testing.assert_array_equal(x, y.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1, 3, 24, 64])
def test_gpu_drift_functions_match_cpu(cuda_device, h):
    """The drift layer's functions on the card against the CPU on the
    same fold state: the same zero set of the decay factors (the
    exponent <= -126 rule holds where CUDA keeps subnormals), the same
    evidence mask, finalize labels and split/retire decisions; factors,
    tau and mass within 1e-5 relative."""
    from repro_torch.core import server as S
    now = 130 * h
    ep = torch.arange(now + 1, dtype=torch.int32)
    f0 = S.decay_factors(ep, now, h)
    f1 = S.decay_factors(ep.to(cuda_device), now, h).cpu()
    assert torch.equal(f1 == 0, f0 == 0)
    assert int((f0 == 0).sum()) == now - 126 * h + 1
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=0)
    rng = np.random.default_rng(h)
    Z, kp, d, k = 40, 3, 6, 8
    centers = (rng.normal(size=(Z, kp, d)) * 5
               + rng.integers(0, 5, size=(Z, 1, 1)) * 50).astype(np.float32)
    w = (0.5 + 2.5 * rng.random((Z, kp))).astype(np.float32)
    w[:4] *= 1e-37                   # products that go subnormal
    st0 = S.aggregate_incremental(
        S.init_state(Z, kp, d, device="cpu"), torch.arange(Z),
        T(centers), T(rng.random((Z, kp)) < 0.9), weights=T(w),
        epochs=T(rng.integers(0, 20 * h, size=Z).astype(np.int32)))
    st1 = S.ServerState(*(t.to(cuda_device) for t in st0))
    horizon = 20 * h
    outs = []
    for st in (st1, st0):
        mask, dw = S.decayed_evidence(st, horizon, h)
        agg = S.finalize(st, k, decay=(horizon, h))
        mass = S.center_mass(agg, mask, dw)
        flat = torch.where(mask[..., None], st.centers,
                           torch.zeros_like(st.centers)).reshape(-1, d)
        sr = S.split_retire(flat, mask.reshape(-1), agg, mass, k,
                            split_factor=1.2, retire_frac=0.5, max_moves=2,
                            weights=dw.reshape(-1))
        outs.append([t.cpu() for t in (mask, dw, agg.center_labels,
                                       agg.tau_centers, mass) + sr])
    got, want = outs
    for i in (0, 2, 6, 7, 8):        # mask, labels, take, donors, moves
        assert torch.equal(got[i], want[i]), i
    assert torch.equal(got[1] == 0, want[1] == 0)
    for i in (1, 3, 4, 5):
        scale = float(want[i].abs().max())
        torch.testing.assert_close(got[i], want[i], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.gpu
def test_gpu_one_rank_nccl_sharded_routed_step(cuda_device, tmp_path):
    """serve_axes with heads on in a one-rank NCCL world: the sharded
    routed step (its votes and outputs gathered over NCCL) serves the
    labels, versions, clusters, routing and predictions of the
    single-device plane, bit for bit."""
    import torch.distributed as dist

    from repro_torch.data.gaussian import (late_device_stream,
                                           structured_devices)
    from repro_torch.fed.api import FederationPlan, Session
    from repro_torch.utils.mesh import make_mesh
    fm = structured_devices(0, k=16, d=24, k_prime=4, m0=4,
                            n_per_comp_dev=25, sep=60.0)
    plan = FederationPlan(k=16, k_prime=4, d=24, capacity=256,
                          batch_size=8, bucket_sizes=(32, 64, 128),
                          refresh_every=4, heads="linear",
                          head_capacity=0.5)
    rr = Session(plan).run(1, fm.data).detail
    stream = late_device_stream(fm.means, 4, 16, 5, n_range=(10, 120))
    reqs, kvs = [r[0] for r in stream], [r[2] for r in stream]
    want = Session.from_round(plan, rr, seed=3).serve_predict(reqs, kvs)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), backend="nccl")
        sharded = plan.with_options(serve_axes=("data",))
        got = Session.from_round(sharded, rr, mesh=mesh,
                                 seed=3).serve_predict(reqs, kvs)
    finally:
        dist.destroy_process_group()
    assert not all(w.routed for w in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.prediction, w.prediction)
        assert (g.tau_version, g.cluster, g.routed) == (
            w.tau_version, w.cluster, w.routed)


# ------------------------------------------------------------- encoder --

ENC_PLAN = dict(k=8, k_prime=3, d=16, capacity=128, batch_size=2,
                bucket_sizes=(16, 32), encoder="qwen1.5-0.5b",
                encode_seq_len=16)


def _token_requests(count, seed, d=16, seq=16):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.normal(size=(int(rng.integers(4, 14)),
                                        int(rng.integers(2, seq + 1)), d)),
                       np.float32) for _ in range(count)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,d", [("qwen1.5-0.5b", 16),
                                    ("granite-3-2b", 32),
                                    ("nemotron-4-15b", 24)])
def test_gpu_apply_encoder_matches_cpu(cuda_device, name, d, dtype):
    """apply_encoder on the card against the CPU on ragged token masks
    (GQA included): f32 within rtol 1e-5 / atol 1e-5, bf16 within 1e-2 of
    max(max|y|, 1) (test_torch_encoder.py's bounds); an item with no
    valid token embeds to exactly 0."""
    from repro_torch.models import encoder as enc
    from repro_torch.models.common import tree_map
    spec = enc.resolve_encoder_spec(name, d)
    params = tree_map(lambda t: t * 5.0, enc.init_encoder(
        torch.Generator().manual_seed(3), spec, device="cpu"))
    rng = np.random.default_rng(d)
    x = T(rng.normal(size=(6, 9, 24, d)), dtype=torch.float32)
    m = T(rng.random((6, 9, 24)) < 0.6)
    m[0, 0] = False
    want = enc.apply_encoder(params, x, m, spec, dtype)
    card = tree_map(lambda t: t.to(cuda_device), params)
    got = enc.apply_encoder(card, x.to(cuda_device), m.to(cuda_device),
                            spec, dtype).cpu()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert not got[0, 0].any()
    if dtype == "f32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        bound = 1e-2 * max(float(want.abs().max()), 1.0)
        torch.testing.assert_close(got, want, rtol=0, atol=bound)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gpu_encode_step_is_step_on_the_embeddings(cuda_device, dtype):
    """On the card the plane's encode step launches solve_attach once and
    gives the labels and reports of the serve step on apply_encoder's
    output, bit for bit."""
    from repro_torch.fed.plane import _make_encode_step, _make_step
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.models import encoder as enc
    from repro_torch.utils.prng import GumbelSource
    cfg = StreamConfig(**{**ENC_PLAN, "encode_dtype": dtype})
    spec = cfg.encoder_spec()
    params = enc.init_encoder(torch.Generator().manual_seed(1), spec,
                              device=cuda_device)
    rng = np.random.default_rng(2)
    x = T(rng.normal(size=(4, 16, 8, 16)), dtype=torch.float32,
          device=cuda_device)
    tm = T(rng.random((4, 16, 8)) < 0.7, device=cuda_device)
    pm = T(rng.random((4, 16)) < 0.8, device=cuda_device)
    kv = torch.full((4,), 3, dtype=torch.int32, device=cuda_device)
    g = GumbelSource(0).draw([0, 1, 2, 3], 3, 16, cuda_device)
    tau = T(np.random.default_rng(0).normal(size=(8, 16)) * 4,
            dtype=torch.float32, device=cuda_device)
    ops.reset_launch_counts()
    got = _make_encode_step(cfg)(tau, params, g, x, pm, kv, tm)
    assert ops.launch_counts()["solve_attach"] == 1
    emb = enc.apply_encoder(params, x, tm, spec, dtype)
    want = _make_step(cfg)(tau, g, emb, pm, kv)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_encoded_v6_save_restore_bitwise(cuda_device, tmp_path):
    """An encoded session (bf16 encoder storage, sync refresh) served,
    saved and restored on the card serves the rest as the live one, bit
    for bit: labels, versions, fold state, encoder leaves and stats."""
    from repro_torch.fed.api import FederationPlan, Session
    plan = FederationPlan(**ENC_PLAN, encode_dtype="bf16", refresh_every=4,
                          device="cuda")
    tau = np.asarray(np.random.default_rng(0).normal(size=(8, 16)) * 4,
                     np.float32)
    live = Session.from_tau(plan, tau, seed=4, device=cuda_device)
    reqs = _token_requests(10, seed=7)
    live.serve(reqs[:5])
    path = live.save(str(tmp_path / "card_v6.npz"))
    restored = Session.restore(path, plan, device=cuda_device)
    assert restored.service.encoder["norm_f"]["w"].is_cuda
    ops.reset_launch_counts()
    got = restored.serve_versioned(reqs[5:])
    assert ops.launch_counts()["solve_attach"] > 0
    want = live.serve_versioned(reqs[5:])
    for (g, gv), (w, wv) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert gv == wv
    for a, b in zip(restored.service.state, live.service.state):
        assert torch.equal(a, b)
    assert restored.stats()["encoder"] == live.stats()["encoder"]
    assert live.tau_version >= 1


# ------------------------------------------------ training (backward) --

# (T, d, E, top_k, capacity factor) of the MoE backward on the card: the
# Mixtral training microbatch's routing shape (4096 tokens of 4096, 8
# experts top-2, 10240 slots), top_k 1, 2 and 4 with dropped entries,
# and d = 12 and 13 (not multiples of 8: bf16's scalar path; 13 also
# f32's).
BWD_SHAPES = [(4096, 4096, 8, 2, 1.25), (64, 128, 4, 1, 1.0),
              (100, 12, 8, 2, 0.5), (70, 36, 6, 4, 0.75),
              (33, 13, 4, 2, 0.6),
              # DeepSeek-V3's routing, top-8 of 256 experts: C = 3, and
              # C = 1 with most entries dropped.
              (64, 128, 256, 8, 1.25), (100, 72, 256, 8, 0.3)]


def moe_routing(device, T, d, E, top_k, cf, dtype, seed=0):
    """x, the routing plan (models/moe.py _route and _plan), the raw
    gates, C and the MoE config of a random router on ``device``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    m = dataclasses.replace(get_config("mixtral-8x7b").moe, n_experts=E,
                            top_k=top_k, capacity_factor=cf)
    g = torch.Generator().manual_seed(seed + T + d)
    x = torch.randn(T, d, generator=g).to(device, dtype)
    router = (torch.randn(d, E, generator=g) * 0.05).to(device, dtype)
    ids, gates, _ = moe._route(router, x, m)
    C = moe._capacity(T, m)
    return x, moe._plan(ids, m, C), gates, C, m


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,E,top_k,cf", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_moe_backward_matches_plain(cuda_device, T, d, E, top_k, cf,
                                        dtype):
    """The dispatch's and the combine's gradients through the kernels
    (ops.moe_dispatch / ops.moe_combine given the routing) against the
    plain formulas (ref.moe_dispatch_bwd / moe_combine_bwd) and against
    autograd of the plain forward, on the card: dx bit for bit with the
    formula (the f32 sum of the kept rows in j order, rounded once) and,
    at top_k <= 2, with autograd; above 2 autograd within (top_k - 1) roundings of the
    terms' magnitudes in x's type; dybuf bit for bit with both; dgates
    within 1e-6 of sum_c |dout * ybuf| of the f64 sum. Two calls give
    the same bits; one launch of each kernel a call (the dispatch's
    backward is moe_dispatch_bwd: no moe_combine launch)."""
    x, plan, gates, C, m = moe_routing(cuda_device, T, d, E, top_k, cf,
                                       dtype)
    src, valid, flat_e, pos_c, keep, src_entry = plan
    S = E * C
    slot = (flat_e * C + pos_c).to(torch.int32)
    g = torch.Generator().manual_seed(T + top_k)
    dbuf = torch.randn(S, d, generator=g).to(cuda_device, dtype)
    ybuf = torch.randn(S, d, generator=g).to(cuda_device, dtype)
    dout = torch.randn(T, d, generator=g).to(cuda_device)

    def kernel_grads():
        xr = x.clone().requires_grad_(True)
        yr = ybuf.clone().requires_grad_(True)
        gr = gates.reshape(-1).clone().requires_grad_(True)
        ops.reset_launch_counts()
        buf = ops.moe_dispatch(xr, src, valid, slot=slot, keep=keep,
                               top_k=top_k)
        dx, = torch.autograd.grad(buf, xr, dbuf)
        y = ops.moe_combine(yr, slot, torch.where(keep, gr, 0.0), top_k,
                            src_entry=src_entry, valid=valid)
        dy, dg = torch.autograd.grad(y, (yr, gr), dout)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert (counts["moe_dispatch"], counts["moe_combine"],
                counts["moe_combine_bwd"],
                counts["moe_dispatch_bwd"]) == (1, 1, 1, 1), counts
        return dx, dy, dg

    dx, dy, dg = kernel_grads()
    dx2, dy2, dg2 = kernel_grads()
    assert_same_bits(dx.float(), dx2.float())
    assert_same_bits(dy.float(), dy2.float())
    assert_same_bits(dg, dg2)

    assert dx.dtype == dtype and dy.dtype == dtype
    assert torch.equal(dx, ref.moe_dispatch_bwd(dbuf, slot, keep, T, top_k,
                                                dtype))
    xr = x.clone().requires_grad_(True)
    want_dx, = torch.autograd.grad(ref.moe_dispatch(xr, src, valid), xr,
                                   dbuf)
    if top_k <= 2:
        assert torch.equal(dx, want_dx)
    else:
        terms = ref.sequential_combine(dbuf.double().abs(), slot,
                                       keep.double(), top_k)
        exact = ref.moe_dispatch_bwd(dbuf.double(), slot, keep, T, top_k)
        unit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
        assert bool(((want_dx.double() - exact).abs()
                     <= (top_k - 1) * unit * terms).all())

    w = torch.where(keep, gates.reshape(-1), 0.0)
    want_dy, want_dg = ref.moe_combine_bwd(dout, ybuf, src_entry, valid, w,
                                           top_k)
    assert torch.equal(dy, want_dy)
    yr = ybuf.clone().requires_grad_(True)
    gr = gates.reshape(-1).clone().requires_grad_(True)
    auto_dy, auto_dg = torch.autograd.grad(
        ref.moe_combine(yr, slot, torch.where(keep, gr, 0.0), top_k),
        (yr, gr), dout)
    assert torch.equal(dy, auto_dy)
    exact_dg = ref.moe_combine_bwd(dout.double(), ybuf.double(), src_entry,
                                   valid, w.double(), top_k)[1]
    terms = ref.moe_combine_bwd(dout.double().abs(), ybuf.double().abs(),
                                src_entry, valid, w.double(), top_k)[1]
    for got in (dg, want_dg, auto_dg):
        assert bool(((got.double() - exact_dg).abs()
                     <= 1e-6 * terms + 1e-30).all())
    assert bool((dg[~keep] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,E,top_k,cf", BWD_SHAPES + [
    (4096, 7168, 256, 8, 1.25)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["routed", "dropped_token", "unaligned"])
def test_gpu_moe_dispatch_bwd_kernel(cuda_device, T, d, E, top_k, cf, dtype,
                                     case):
    """The dispatch's backward kernel alone against ref.moe_dispatch_bwd,
    bit for bit, at BWD_SHAPES and DeepSeek-V3's train routing (4096
    tokens of 7168, top-8 of 256): the vector path and the scalar one
    (d = 12 in bf16, d = 13; dbuf off a 16-byte boundary), a token whose
    every entry is dropped beside a row of inf at a dropped entry's
    clamped slot (the dropped token's dx 0, inf only where a kept entry
    reads it); on the model's routing also the old route's bits (moe_combine with 0/1 gates, then the cast). Two
    calls give the same bits and count two launches."""
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import moe_dispatch_bwd as mdb
    _, plan, _, C, _ = moe_routing(cuda_device, T, d, E, top_k, cf, dtype)
    _, _, flat_e, pos_c, keep, _ = plan
    slot = (flat_e * C + pos_c).to(torch.int32)
    S = E * C
    dbuf = torch.randn(S, d, generator=torch.Generator().manual_seed(
        T + d + top_k)).to(cuda_device, dtype)
    if case == "dropped_token":
        keep = keep.clone()
        keep[:top_k] = False                  # token 0
        dbuf[int(slot[0])] = float("inf")
        dbuf[int(slot[0]), ::2] = -float("inf")
    elif case == "unaligned":
        buf = torch.zeros(S * d + 1, dtype=dtype, device=cuda_device)
        buf[1:] = dbuf.reshape(-1)
        dbuf = buf[1:].view(S, d)
    before = mdb.LAUNCHES
    got = mdb.moe_dispatch_bwd(dbuf, slot, keep, top_k)
    again = mdb.moe_dispatch_bwd(dbuf, slot, keep, top_k)
    assert mdb.LAUNCHES == before + 2
    want = ref.moe_dispatch_bwd(dbuf, slot, keep, T, top_k)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (T, d)
    assert_same_bits(got.float(), want.float())
    assert_same_bits(got.float(), again.float())
    if case == "dropped_token":
        assert bool((got[0] == 0).all())
        inf_rows = torch.isinf(want.float()).any(dim=1)
        assert int(inf_rows.sum()) <= 1 and not bool(inf_rows[0])
    if case == "routed":
        old = mc.moe_combine(dbuf, slot, keep.float(), top_k).to(dtype)
        torch.cuda.synchronize()
        assert_same_bits(got.float(), old.float())


# (T, d, capacity factor) of DeepSeek-V3's forward routing at top-8 of
# 256 experts on the card: its decode step (4 tokens of 7168, C = 1), a
# small prefill (C = 3), drops at C = 1, and d = 72 (bf16's vector path
# with a ragged piece count).
TOP8_SHAPES = [(4, 7168, 1.25), (64, 128, 1.25), (200, 72, 0.2)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,cf", TOP8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_moe_top8_of_256_forward_matches_plain(cuda_device, T, d, cf,
                                                   dtype):
    """The layer's forward kernels at DeepSeek-V3's routing (top-8 of
    256 experts, the model's own _route and _plan): moe_dispatch bit for
    bit with its plain version; moe_combine bit for bit with the
    sequential sum (choices in order) and within 1e-6 of the terms'
    magnitudes of the plain version (torch.sum over the 8 choices);
    one launch each."""
    x, plan, gates, C, m = moe_routing(cuda_device, T, d, 256, 8, cf, dtype)
    src, valid, flat_e, pos_c, keep, _ = plan
    slot = (flat_e * C + pos_c).to(torch.int32)
    w = torch.where(keep, gates.reshape(-1), 0.0).float()
    ybuf = torch.randn(256 * C, d, generator=torch.Generator().manual_seed(
        T)).to(cuda_device, dtype)
    ops.reset_launch_counts()
    buf = ops.moe_dispatch(x, src, valid)
    y = ops.moe_combine(ybuf, slot, w, 8)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["moe_dispatch"], counts["moe_combine"]) == (1, 1)
    assert torch.equal(buf, ref.moe_dispatch(x, src, valid))
    assert_same_bits(y, sequential_combine(ybuf, slot, w, 8))
    terms = sequential_combine(ybuf.abs(), slot, w.abs(), 8)
    assert bool(((y - ref.moe_combine(ybuf, slot, w, 8)).abs()
                 <= 1e-6 * terms + 1e-30).all())
    if cf < 1:
        assert not bool(keep.all())


def _reduced_deepseek(dtype="float32", **kw):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("deepseek-v3-671b", reduced=True).replace(dtype=dtype,
                                                              **kw)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(2))


@pytest.mark.gpu
def test_gpu_mla_generate_matches_cpu(cuda_device):
    """Reduced DeepSeek-V3 (f32; MLA prefill, the absorbed latent decode,
    a dense and a MoE layer) through launch.serve.generate on the card
    and on the CPU from the same parameters: 48-token prompts, 8 steps;
    tokens exact, logits within 1e-4 of their largest magnitude, the
    latent cache within 1e-5; the MoE layer launches each routing kernel
    once in the prefill and once a step."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import tree_map
    cfg, model, params = _reduced_deepseek()
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 48)), dtype=torch.int32)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        ops.reset_launch_counts()
        stats = {}
        out = generate(model, tree_map(lambda a: a.to(dev), params),
                       {"tokens": toks}, steps=8, stats=stats)
        if dev.type == "cuda":
            counts = ops.launch_counts()
            assert counts["moe_dispatch"] == counts["moe_combine"] == 9
        runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                             for lg in stats["logits"]]),
                     tree_map(lambda a: a.cpu(), stats["cache"])))
    (t1, l1, c1), (t0, l0, c0) = runs
    assert torch.equal(t1, t0)
    assert float((l1 - l0).abs().max()) <= 1e-4 * float(l0.abs().max())
    for s1, s0 in zip(c1["segments"], c0["segments"]):
        assert sorted(s1) == ["latent", "rope"]
        for k in s1:
            assert float((s1[k] - s0[k]).abs().max()) <= 1e-5 * float(
                s0[k].abs().max())


@pytest.mark.gpu
def test_gpu_mla_loss_and_grads_match_cpu(cuda_device):
    """Reduced DeepSeek-V3 with 16 experts at top-8 (f32): the loss
    (ce, aux, mtp_ce) within 1e-5 relative and every gradient within
    1e-4 of its leaf's largest magnitude against the CPU; the MoE
    layer's backward kernels launch once."""
    import dataclasses

    from repro_torch.launch.train import _value_and_grad
    from repro_torch.models.common import tree_map
    from repro_torch.utils.tree import leaves
    from repro_torch.configs import get_config
    moe = dataclasses.replace(get_config("deepseek-v3-671b",
                                         reduced=True).moe,
                              n_experts=16, top_k=8)
    cfg, model, params = _reduced_deepseek(moe=moe)
    rng = np.random.default_rng(4)
    toks = T(rng.integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32))
    labels = T(rng.integers(0, cfg.vocab_size, size=(2, 40)).astype(
        np.int32))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        ops.reset_launch_counts()
        loss, met, g = _value_and_grad(model, None,
                                       tree_map(lambda a: a.to(dev), params),
                                       {"tokens": toks.to(dev),
                                        "labels": labels.to(dev)})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["moe_combine_bwd"] == counts["moe_dispatch_bwd"] == 1
        outs.append((loss, met, g))
    (l1, m1, g1), (l0, m0, g0) = outs
    assert sorted(m1) == ["aux", "ce", "mtp_ce"]
    for a, b in [(l1, l0)] + [(m1[k], m0[k]) for k in m0]:
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    for a, b in zip(leaves(g1), leaves(g0)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max()) + 1e-30


def _sliced_trees(seed, device):
    """Parameters and a gradient whose leaves span many slices of a
    CHUNK of 1000: a stack of matrices, a tall matrix, a vector."""
    g = torch.Generator().manual_seed(seed)

    def tree_of(scale):
        return {"stack": torch.randn(3, 300, 70, generator=g) * scale,
                "tall": torch.randn(257, 129, generator=g) * scale,
                "vec": torch.randn(5000, generator=g) * scale}
    return ({k: v.to(device) for k, v in tree_of(1.0).items()},
            [{k: v.to(device) for k, v in tree_of(0.3).items()}
             for _ in range(3)])


@pytest.mark.gpu
def test_gpu_sliced_adafactor_and_clip_match_cpu(cuda_device, monkeypatch):
    """adafactor and clip_by_global_norm over slices of 1000 elements
    (matrices in row blocks, the stack matrix by matrix) on the card
    against the CPU: the clip's norm and the clipped gradients within
    1e-6 relative; 3 adafactor updates, parameters and the factored
    state within 1e-6 of each leaf's largest magnitude."""
    from repro_torch import optim
    from repro_torch.utils.tree import leaves
    monkeypatch.setattr(optim.optimizers, "CHUNK", 1000)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        params, grads = _sliced_trees(5, dev)
        clipped, gn = optim.clip_by_global_norm(
            {k: v.clone() for k, v in grads[0].items()}, 0.5)
        opt = optim.build_optimizer("adafactor", 0.05, weight_decay=0.1)
        state = opt.init(params)
        for i, g in enumerate(grads):
            params, state = opt.update(
                g, state, params, torch.tensor(i, dtype=torch.int32,
                                               device=dev))
        runs.append((float(gn), [a.cpu() for a in leaves(clipped)],
                     [a.cpu() for a in leaves(params)],
                     [a.cpu() for a in leaves(state)]))
    (n1, c1, p1, s1), (n0, c0, p0, s0) = runs
    assert abs(n1 - n0) <= 1e-6 * n0
    for a, b in zip(c1 + p1 + s1, c0 + p0 + s0):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def _train_states(model, device, seed=0):
    """One optimizer (adamw, lr 1e-3, eps 1e-4) and a state drawn on
    the CPU, copied to the CPU and to ``device``."""
    from repro_torch.launch.train import TrainState
    from repro_torch.models.common import tree_map
    from repro_torch.optim import build_optimizer
    opt = build_optimizer("adamw", 1e-3, eps=1e-4)
    params = model.init(torch.Generator().manual_seed(seed))
    opt_state = opt.init(params)
    return opt, [TrainState(tree_map(lambda a: a.clone().to(dev), params),
                            tree_map(lambda a: a.clone().to(dev), opt_state),
                            torch.zeros((), dtype=torch.int32, device=dev))
                 for dev in (device, torch.device("cpu"))]


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu(cuda_device):
    """Reduced Mixtral (f32, capacity factor 0.75 so that entries drop,
    microbatch 2): 3 steps of launch.train.make_train_step on the card
    and on the CPU from the same state. Loss and grad norm within 1e-5
    relative, parameters within 1e-5 of each leaf's largest magnitude
    plus 1e-6 (adamw at eps 1e-4, as tests/test_torch_train.py states);
    every MoE layer launches the backward kernels once a microbatch and
    the combine only in the forward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    cfg = get_config("mixtral-8x7b", reduced=True)
    cfg = cfg.replace(dtype="float32", microbatch=2,
                      moe=dataclasses.replace(cfg.moe, capacity_factor=0.75))
    model = build_model(cfg)
    opt, (card, cpu) = _train_states(model, cuda_device)
    step = make_train_step(model, None, opt)
    rng = np.random.default_rng(0)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, size=(4, 32)).astype(
            np.int32)
        labels[:, ::5] = -1
        ops.reset_launch_counts()
        card, got = step(card, {"tokens": T(toks).to(cuda_device),
                                "labels": T(labels).to(cuda_device)})
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["moe_combine_bwd"] == 2 * cfg.n_layers, counts
        assert counts["moe_dispatch_bwd"] == 2 * cfg.n_layers, counts
        assert counts["moe_dispatch"] == 2 * cfg.n_layers, counts
        assert counts["moe_combine"] == 2 * cfg.n_layers, counts
        cpu, want = step(cpu, {"tokens": T(toks), "labels": T(labels)})
        for key in ("loss", "grad_norm"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-5 * abs(
                float(want[key])), (i, key)
        for a, b in zip(leaves(card.params), leaves(cpu.params)):
            err = float((a.cpu() - b).abs().max())
            assert err <= 1e-5 * float(b.abs().max()) + 1e-6, i


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_moe_loss_gradient_reaches_router_and_experts(cuda_device,
                                                          dtype):
    """A MoE loss's gradient on the card reaches the router and every
    expert weight of every MoE layer (a kernel output without a
    gradient would leave them at 0), and in f32 agrees with the CPU's
    within 1e-4 of each leaf's largest magnitude (in bf16 only the reach
    is checked: a router tie broken the other way on one device moves
    an expert's gradient by more than any tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import _value_and_grad
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    cfg = get_config("mixtral-8x7b", reduced=True).replace(dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    toks = T(rng.integers(0, cfg.vocab_size, size=(2, 48)).astype(np.int32))
    labels = T(rng.integers(0, cfg.vocab_size, size=(2, 48)).astype(
        np.int32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        ops.reset_launch_counts()
        _, _, g = _value_and_grad(model, None,
                                  tree_map(lambda a: a.to(dev), params),
                                  {"tokens": toks.to(dev),
                                   "labels": labels.to(dev)})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["moe_combine_bwd"] == cfg.n_layers
            assert counts["moe_dispatch_bwd"] == cfg.n_layers
        grads.append(g)
    for seg_card, seg_cpu in zip(grads[0]["segments"], grads[1]["segments"]):
        for name in ("router", "w1", "w2", "w3"):
            a, b = seg_card["moe"][name], seg_cpu["moe"][name]
            per_layer = a.flatten(1).abs().amax(dim=1)
            assert bool((per_layer > 0).all()), name
            if dtype == "float32":
                err = float((a.cpu() - b).abs().max())
                assert err <= 1e-4 * float(b.abs().max()), name


# --------------------------------------- RWKV-6 and the Zamba2 hybrid --

STATE_MODELS = {"rwkv6-7b": {},
                "zamba2-1.2b": dict(n_layers=5, hybrid_attn_every=2)}


def _reduced_state_model(name):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(name, reduced=True).replace(dtype="float32",
                                                 **STATE_MODELS[name])
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _state_generate_matches_cpu(device, name):
    """Greedy generate on the card and on the CPU from the same
    parameters (f32): 2 prompts of 48 tokens (a chunked prefill) and of
    50 (the scan), 4 steps each; tokens exact, logits and every cache
    leaf (states, shared-block caches) within 1e-5 of their largest
    magnitude; no kernel of the port launched (these paths have none)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import tree_map
    from repro_torch.utils.tree import leaves
    cfg, model, params = _reduced_state_model(name)
    for S in (48, 50):
        toks = torch.as_tensor(np.random.default_rng(S).integers(
            0, cfg.vocab_size, size=(2, S)), dtype=torch.int32)
        runs = []
        for dev in (device, torch.device("cpu")):
            ops.reset_launch_counts()
            stats = {}
            out = generate(model, tree_map(lambda a: a.to(dev), params),
                           {"tokens": toks}, steps=4, stats=stats)
            if dev.type == "cuda":
                assert sum(ops.launch_counts().values()) == 0
            runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                                 for lg in stats["logits"]]),
                         leaves(tree_map(lambda a: a.cpu(), stats["cache"]))))
        (t1, l1, c1), (t0, l0, c0) = runs
        assert torch.equal(t1, t0)
        assert float((l1 - l0).abs().max()) <= 1e-5 * float(l0.abs().max())
        assert len(c1) == len(c0)
        for a, b in zip(c1, c0):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert float((a.float() - b.float()).abs().max()) <= 1e-5 * float(
                b.float().abs().max())


def _state_loss_and_grads_match_cpu(device, name):
    """The loss within 1e-5 relative and every gradient within 1e-5 of
    its leaf's largest magnitude against the CPU (f32, 2 x 32 tokens: a
    chunked sequence), with remat on (each state-carrying layer
    recomputed in the backward)."""
    from repro_torch.launch.train import _value_and_grad
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    cfg, _, params = _reduced_state_model(name)
    model = build_model(cfg.replace(remat=True))
    rng = np.random.default_rng(4)
    toks = T(rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int32))
    labels = T(rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(
        np.int32))
    outs = []
    for dev in (device, torch.device("cpu")):
        outs.append(_value_and_grad(model, None,
                                    tree_map(lambda a: a.to(dev), params),
                                    {"tokens": toks.to(dev),
                                     "labels": labels.to(dev)}))
    (l1, m1, g1), (l0, m0, g0) = outs
    assert sorted(m1) == ["aux", "ce"]
    for a, b in ((l1, l0), (m1["ce"], m0["ce"])):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    for a, b in zip(leaves(g1), leaves(g0)):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
            b.abs().max()) + 1e-30


@pytest.mark.gpu
def test_gpu_rwkv_generate_matches_cpu(cuda_device):
    _state_generate_matches_cpu(cuda_device, "rwkv6-7b")


@pytest.mark.gpu
def test_gpu_rwkv_loss_and_grads_match_cpu(cuda_device):
    _state_loss_and_grads_match_cpu(cuda_device, "rwkv6-7b")


@pytest.mark.gpu
def test_gpu_hybrid_generate_matches_cpu(cuda_device):
    _state_generate_matches_cpu(cuda_device, "zamba2-1.2b")


@pytest.mark.gpu
def test_gpu_hybrid_loss_and_grads_match_cpu(cuda_device):
    _state_loss_and_grads_match_cpu(cuda_device, "zamba2-1.2b")


# ------------------------------- Whisper (encdec) and InternVL2 (vlm) --

@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,dh,W", [
    (4, 48, 8, 128, 4096),  # InternVL2's ring: g=6 in a block of 8 rows
    (2, 12, 2, 128, 100),   # g=6, one chunk (S = 1)
    (3, 6, 2, 128, 4096),   # g=3 in a block of 4 rows
    (2, 6, 2, 128, 300),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_swa_decode_partial_row_groups(cuda_device, b, h, kvh, dh, W,
                                           dtype):
    """Groups of 6 and 3 query rows, which the kernel rounds up to 8 and
    4: every row of every head against the plain version (a row past the
    group written would land on the next kv head's rows), the bits the
    same on a second call, one launch a call."""
    from repro_torch.kernels import swa_decode as sw
    q, kw, vw, bias = swa_inputs(h * W + b, b, h, kvh, dh, W, "scattered")
    q, kw, vw = (torch.as_tensor(a).to(cuda_device, dtype)
                 for a in (q, kw, vw))
    bias = torch.as_tensor(bias).to(cuda_device)
    before = sw.LAUNCHES
    got = sw.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    again = sw.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    assert sw.LAUNCHES == before + 2
    want = ref.swa_decode_attention(q, kw, vw, bias, 1.0 / np.sqrt(dh))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for i in range(h):
        assert_swa_close(got[:, i], want[:, i], dtype)


FAMILY_MODELS = {"whisper-base": {}, "internvl2-26b": {},
                 "internvl2-26b ring": dict(sliding_window=32)}


def _reduced_family_model(label, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(label.split()[0], reduced=True).replace(
        dtype="float32", **FAMILY_MODELS[label], **kw)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def family_inputs(cfg, B, seed):
    """The family's inputs beside the tokens, x 0.02 as the JAX package's
    dummy_inputs: Whisper's enc_embeds (B, n_ctx, d), InternVL2's
    patch_embeds (B, n_prefix, d)."""
    rng = np.random.default_rng(1000 + seed)
    name = "enc_embeds" if cfg.family == "encdec" else "patch_embeds"
    n = cfg.encoder.n_ctx if cfg.family == "encdec" else cfg.encoder.n_prefix
    return {name: T((rng.normal(size=(B, n, cfg.d_model)) * 0.02).astype(
        np.float32))}


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(FAMILY_MODELS))
def test_gpu_family_generate_matches_cpu(cuda_device, label):
    """Greedy generate of reduced Whisper, InternVL2 and InternVL2's
    sliding-window variant (W=32; 16 patches and 16 tokens, then 6 steps
    over the ring, each layer through swa_decode) on the card and on the
    CPU from the same parameters (f32): tokens exact, logits and every
    cache leaf (the encoder's ck / cv / cvalid included) within 1e-5 of
    their largest magnitude."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import tree_map
    from repro_torch.utils.tree import leaves
    cfg, model, params = _reduced_family_model(label)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 16)), dtype=torch.int32)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        ops.reset_launch_counts()
        stats = {}
        out = generate(model, tree_map(lambda a: a.to(dev), params),
                       {"tokens": toks, **family_inputs(cfg, 2, 2)},
                       steps=6, stats=stats)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            ring = cfg.sliding_window is not None
            assert ops.launch_counts()["swa_decode"] == (
                6 * cfg.n_layers if ring else 0)
        runs.append((out.cpu(), torch.stack([lg.float().cpu()
                                             for lg in stats["logits"]]),
                     leaves(tree_map(lambda a: a.cpu(), stats["cache"]))))
    (t1, l1, c1), (t0, l0, c0) = runs
    assert torch.equal(t1, t0)
    assert float((l1 - l0).abs().max()) <= 1e-5 * float(l0.abs().max())
    assert len(c1) == len(c0)
    for a, b in zip(c1, c0):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * float(
            b.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["whisper-base", "internvl2-26b"])
def test_gpu_family_gradient_reaches_encoder_and_projection(cuda_device,
                                                             label):
    """The loss on the card, with remat on (each layer recomputed in the
    backward, the encoder's output an argument of every decoder layer):
    the loss within 1e-5 relative and every gradient within 1e-5 of its
    leaf's largest magnitude against the CPU, and the gradient of every
    enc_segments / enc_norm leaf (Whisper) or of vis_proj (InternVL2)
    nonzero."""
    from repro_torch.launch.train import _value_and_grad
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    cfg, _, params = _reduced_family_model(label)
    model = build_model(cfg.replace(remat=True))
    rng = np.random.default_rng(4)
    toks = T(rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32))
    labels = T(rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(
        np.int32))
    extra = family_inputs(cfg, 2, 4)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        outs.append(_value_and_grad(
            model, None, tree_map(lambda a: a.to(dev), params),
            {"tokens": toks.to(dev), "labels": labels.to(dev),
             **{k: v.to(dev) for k, v in extra.items()}}))
    (l1, _, g1), (l0, _, g0) = outs
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, b in zip(leaves(g1), leaves(g0)):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
            b.abs().max()) + 1e-30
    reach = (leaves(g1["enc_segments"]) + leaves(g1["enc_norm"])
             if cfg.family == "encdec" else [g1["vis_proj"]])
    assert reach and all(a.is_cuda and bool(a.abs().max() > 0)
                         for a in reach)


# ------------------------------------------ expert-parallel MoE (mesh) --


@pytest.fixture
def nccl_one_rank(cuda_device, tmp_path):
    """A one-rank NCCL world in the test's process and its (data=1,
    model=1) mesh's context; the world is torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.sharding import make_ctx
    from repro_torch.utils.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_ctx(make_mesh((1, 1), ("data", "model"),
                                 backend="nccl"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.bool])
def test_gpu_all_to_all_one_rank_nccl(nccl_one_rank, dtype):
    """Every group of a one-rank NCCL mesh is a group of one: the
    exchange returns the tensor itself, with its dtype and bits."""
    mesh = nccl_one_rank.mesh
    x = torch.arange(24, device="cuda").reshape(4, 6) % 5
    x = x == 0 if dtype == torch.bool else x.to(dtype)
    for axes in (("data",), ("model",), ("data", "model"),
                 ("model", "data")):
        got = mesh.group(axes).all_to_all(x)
        assert got.dtype == dtype and torch.equal(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("impl,ep", [("dense", "tp"), ("alltoall", "tp"),
                                     ("alltoall", "2d")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [0, 1])
def test_gpu_moe_paths_one_rank_equal_local(nccl_one_rank, impl, ep, dtype,
                                            shared):
    """At one shard every path of apply_moe under a mesh (expert tensor
    parallelism for impl="dense", all_to_all expert parallelism for
    "alltoall") is the local path: output and aux bit for bit against
    apply_moe without a mesh on the card (d=64, 8 experts top-2 of 96,
    capacity 1.25: tokens drop), through the port's kernels."""
    from types import SimpleNamespace

    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    ctx = nccl_one_rank
    m = MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=shared,
                  capacity_factor=1.25, impl=impl, ep=ep)
    cfg = SimpleNamespace(moe=m, d_model=64)
    p = moe.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg,
                     dtype)
    x = torch.randn((3, 40, 64), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda").to(dtype)
    assert moe.moe_path(m, 3, 40, ctx) == ("etp" if impl == "dense"
                                          else "alltoall")
    ops.reset_launch_counts()
    got, gaux = moe.apply_moe(p, x, cfg, ctx)
    counts = ops.launch_counts()
    want, waux = moe.apply_moe(p, x, cfg)
    assert counts["moe_dispatch"] == 1 and counts["moe_combine"] == 1
    assert torch.equal(got, want) and torch.equal(gaux, waux)


@pytest.mark.gpu
def test_gpu_collectives_backward_one_rank_nccl(nccl_one_rank):
    """Every differentiable collective of a one-rank NCCL mesh's groups
    (the whole mesh's group crosses NCCL's world of one), forward and
    backward on CUDA tensors: each is the identity both ways (a group of
    one), the gradient the cotangent's bits."""
    mesh = nccl_one_rank.mesh
    gen = torch.Generator(device="cuda").manual_seed(0)
    for axes in (("data",), ("model",), ("data", "model"),
                 ("model", "data")):
        g = mesh.group(axes)
        ops_ = {"psum": g.psum, "all_gather": g.all_gather,
                "all_gather_rs": lambda t: g.all_gather(
                    t, grad="reduce_scatter"),
                "all_to_all": g.all_to_all, "psum_grad": g.psum_grad,
                "shard_rows": g.shard_rows}
        for name, fn in ops_.items():
            x = torch.randn((4, 6), generator=gen, device="cuda",
                            requires_grad=True)
            ct = torch.randn((4, 6), generator=gen, device="cuda")
            y = fn(x)
            (grad,) = torch.autograd.grad(y, x, ct)
            assert torch.equal(y, x) and torch.equal(grad, ct), (axes, name)


@pytest.mark.gpu
@pytest.mark.parametrize("impl,ep", [("dense", "tp"), ("alltoall", "tp"),
                                     ("alltoall", "2d")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_moe_grads_one_rank_equal_local(nccl_one_rank, impl, ep, dtype):
    """At one shard the gradient through every path of apply_moe under a
    mesh (the router's, each expert leaf's and x's) is the local path's,
    bit for bit, through the port's kernels and their backward."""
    from types import SimpleNamespace

    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    m = MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                  capacity_factor=1.25, impl=impl, ep=ep)
    cfg = SimpleNamespace(moe=m, d_model=64)
    p = moe.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg,
                     dtype)
    x = torch.randn((3, 40, 64), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda").to(dtype)
    dy = torch.randn((3, 40, 64), generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda").to(dtype)
    grads = []
    for ctx in (nccl_one_rank, None):
        leaves_ = [p["router"], p["w1"], p["w3"], p["w2"], x]
        req = [t.detach().requires_grad_(True) for t in leaves_]
        pp = dict(p, router=req[0], w1=req[1], w3=req[2], w2=req[3])
        y, aux = moe.apply_moe(pp, req[4], cfg, ctx)
        grads.append(torch.autograd.grad((y.float() * dy.float()).sum()
                                         + aux, req))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_train_step_one_rank_nccl_equals_local(nccl_one_rank):
    """Two steps of make_train_step under the one-rank NCCL mesh: reduced
    Mixtral (adamw, the etp path) and reduced DeepSeek-V3 (adafactor,
    alltoall over ("data", "model"), MTP) give the single-device step's
    loss, grad norm, parameters and optimizer state bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    for name, over, opt_name in (
            ("mixtral-8x7b", {}, "adamw"),
            ("deepseek-v3-671b", {"impl": "alltoall", "ep": "2d"},
             "adafactor")):
        cfg = get_config(name, reduced=True).replace(dtype="float32")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **over))
        model = build_model(cfg)
        rng = np.random.default_rng(0)
        batches = [{k: torch.as_tensor(rng.integers(
            0, cfg.vocab_size, size=(2, 32)).astype(np.int32),
            device="cuda") for k in ("tokens", "labels")}
            for _ in range(2)]
        runs = []
        for ctx in (nccl_one_rank, None):
            opt = build_optimizer(opt_name, 1e-3)
            state = init_state(model, torch.Generator(
                device="cuda").manual_seed(0), opt, ctx=ctx)
            step = make_train_step(model, ctx, opt)
            mets = []
            for b in batches:
                state, met = step(state, b)
                mets.append((met["loss"].item(), met["grad_norm"].item()))
            runs.append((mets, leaves(state.params) + leaves(state.opt)))
        (m1, t1), (m0, t0) = runs
        assert m1 == m0, name
        assert all(torch.equal(a, b) for a, b in zip(t1, t0)), name


@pytest.mark.gpu
def test_gpu_reduce_scatter_one_rank_nccl(nccl_one_rank):
    """reduce_scatter over every group of a one-rank NCCL mesh (a group of
    one), along dims 0 and 1: the identity both ways, the gradient the
    cotangent's bits."""
    mesh = nccl_one_rank.mesh
    gen = torch.Generator(device="cuda").manual_seed(0)
    for axes in (("data",), ("model",), ("data", "model"),
                 ("model", "data")):
        g = mesh.group(axes)
        for dim in (0, 1):
            x = torch.randn((4, 6), generator=gen, device="cuda",
                            requires_grad=True)
            ct = torch.randn((4, 6), generator=gen, device="cuda")
            y = g.reduce_scatter(x, dim=dim)
            (grad,) = torch.autograd.grad(y, x, ct)
            assert torch.equal(y, x) and torch.equal(grad, ct), (axes, dim)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_vocab_parallel_cross_entropy_one_rank(nccl_one_rank, dtype):
    """The vocab-parallel cross-entropy (models/common.vocab_parallel_nll
    and masked_mean) over the one-rank NCCL mesh's model group against
    cross_entropy on the card: the loss and the logits' gradient within
    1e-6 relative (both in f32; the max, the sum of exponentials and the
    label's logit taken in another order than logsumexp's)."""
    from repro_torch.models.common import (cross_entropy, masked_mean,
                                           vocab_parallel_nll)
    ctx = nccl_one_rank
    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = (torch.randn((2, 24, 1000), generator=gen, device="cuda")
              * 4).to(dtype)
    labels = torch.randint(0, 1000, (2, 24), generator=gen, device="cuda")
    mask = torch.rand((2, 24), generator=gen, device="cuda") < 0.8
    got, want = [], []
    for fn, out in ((lambda lg: masked_mean(vocab_parallel_nll(
            lg, labels, 0, ctx.mesh.group("model")), mask, ctx), got),
            (lambda lg: cross_entropy(lg, labels, mask), want)):
        lg = logits.detach().requires_grad_(True)
        loss = fn(lg)
        out += [loss, torch.autograd.grad(loss, lg)[0].float()]
    assert abs(float(got[0].detach() - want[0].detach())) <= 1e-6 * abs(
        float(want[0].detach()))
    err = float((got[1] - want[1]).abs().max())
    assert err <= 1e-6 * float(want[1].abs().max()) + 1e-12, err


@pytest.mark.gpu
def test_gpu_tp1_reduced_mixtral_equals_local(nccl_one_rank):
    """tp1's claim at reduced width: Mixtral with fsdp and seq_shard on
    (every dense layout's code path; at one rank every part is the whole
    leaf and every collective a group of one) under the one-rank NCCL
    mesh gives the single-device run's bits: generate's tokens and every
    logit (bf16, through swa_decode, moe_dispatch and moe_combine), and
    two train steps' loss, grad norm and parameters."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    cfg = get_config("mixtral-8x7b", reduced=True).replace(
        fsdp=True, seq_shard=True, microbatch=2)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 96)),
                              dtype=torch.int32)
    batches = [{k: torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32), device="cuda")
        for k in ("tokens", "labels")} for _ in range(2)]
    runs = []
    for ctx in (nccl_one_rank, None):
        params = init_params(model, seed=0, device="cuda", ctx=ctx)
        stats = {}
        toks = generate(model, params, {"tokens": prompts}, steps=8,
                        ctx=ctx, stats=stats)
        opt = build_optimizer("adamw", 1e-3)
        state = init_state(model, torch.Generator(
            device="cuda").manual_seed(0), opt, ctx=ctx)
        step = make_train_step(model, ctx, opt)
        mets = []
        for b in batches:
            state, met = step(state, b)
            mets.append((met["loss"].item(), met["grad_norm"].item()))
        runs.append((toks, stats["logits"], mets, leaves(state.params)))
    (t1, l1, m1, p1), (t0, l0, m0, p0) = runs
    assert torch.equal(t1, t0)
    assert all(torch.equal(a, b) for a, b in zip(l1, l0))
    assert m1 == m0
    assert all(torch.equal(a, b) for a, b in zip(p1, p0))
