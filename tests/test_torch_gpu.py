"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``gpu``; they skip without one). This file imports neither
jax nor the JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -p no:warnings --noconftest \\
        -m gpu tests/test_torch_gpu.py

Integer outputs exactly; sums and centers within rtol=1e-5, atol=1e-4;
min squared distances within the cancellation bound of the expanded form
||x||^2 - 2x.c + ||c||^2, 1e-6 * (||x_i||^2 + ||c_{a_i}||^2) + 1e-6.
The helpers here are shared with test_torch_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

T = torch.as_tensor

SOLVE_SHAPES = [(1, 16, 3, 2, 4, 100), (4, 33, 7, 3, 7, 9),
                (3, 40, 37, 5, 9, 7), (2, 64, 48, 4, 12, 50)]


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


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,k", [(1, 5, 3, 2), (3, 70, 33, 7),
                                     (50, 400, 300, 10), (2, 3000, 129, 5)])
def test_gpu_kmeans_update_matches_plain(cuda_device, B, n, d, k):
    from repro_torch.kernels.kmeans_update import kmeans_update
    g = torch.Generator().manual_seed(n + k)
    x = torch.randn(B, n, d, generator=g).to(cuda_device)
    a = torch.randint(-1, k, (B, n), generator=g).int().to(cuda_device)
    w = torch.rand(B, n, generator=g).to(cuda_device)
    for weights in (None, w):
        s, c = kmeans_update(x, a, k, weights)
        rs, rc = ref.kmeans_update(x, a, k, weights)
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(c, rc, rtol=1e-5, atol=1e-4)


def _clustered_batch(seed, B, n, d, kp, k):
    """Requests drawn around tau centers (the serve path's data), so no
    point sits on a Voronoi boundary at float precision."""
    rng = np.random.default_rng(seed)
    tau = (rng.normal(size=(k, d)) * 10).astype(np.float32)
    lab = rng.integers(0, k, size=(B, n))
    x = (tau[lab] + rng.normal(size=(B, n, d))).astype(np.float32)
    c0 = np.ascontiguousarray(x[:, :kp])
    cm = np.ones((B, kp), bool)
    cm[-1, -1] = False
    pm = np.ones((B, n), bool)
    pm[0, n // 2:] = False
    return tau, x, c0, cm, pm


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,kp,k,iters", SOLVE_SHAPES
                         + [(8, 1024, 300, 10, 100, 100)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gpu_solve_attach_matches_plain(cuda_device, B, n, d, kp, k, iters,
                                        dtype):
    make = _clustered_batch if n >= 1024 else request_batch
    tau, x, c0, cm, pm = make(n * 13 + k, B, n, d, kp, k)
    args = [T(v).to(cuda_device) for v in (x, c0, tau, cm, pm)]
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
