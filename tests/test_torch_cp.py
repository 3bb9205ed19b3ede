"""The context-parallel decode cache's pieces against the JAX package, on
the CPU: the softmax state of a block of the keys (``kernels/ref.
swa_decode_partial``, ``models/attention.decode_partial``) and their
merge in block order (``kernels/ref.merge_states``), with the keys split
into 2 and 4 blocks (and each block into chunks), against
``repro.kernels.ref.swa_decode_attention`` and the reference's
``decode_attention`` (``repro/models/attention.py``) within 1e-6 of the
largest output in f32: a block whose keys are all masked weighs
nothing, and a row masked everywhere averages V over every slot. Also
``launch/sharding.seq_block`` (the blocks in shard order, none where
the batch or nothing divides) and ``models/attention.write_rows`` (only
the block holding a row writes it). The ranks' merge under a mesh is
held to JAX's sharded decode by ``test_torch_tp.py`` and
``test_torch_tp_families.py``; the CUDA partial and combine entry points
to these plain versions by ``test_torch_gpu.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.common import DistCtx  # noqa: E402

TOL = 1e-6
# (b, h, kvh, dh, W): GQA groups of 4, 1 and 2; W not a multiple of 4.
SHAPES = [(3, 8, 2, 32, 64), (3, 4, 4, 16, 48), (4, 6, 3, 8, 36)]


def inputs(seed, b, h, kvh, dh, W):
    """q, kw, vw and the valid slots (numpy, f32): about a third of the
    slots empty; row 0's first quarter all empty (its first block of 4
    holds no key), row 1 keys in its last quarter only (its first block
    of 2 and first 3 of 4 hold none), the last row empty everywhere."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kw = rng.normal(size=(b, W, kvh, dh)).astype(np.float32)
    vw = rng.normal(size=(b, W, kvh, dh)).astype(np.float32)
    valid = rng.random((b, W)) < 0.65
    valid[0, :W // 4] = False
    valid[0, -1] = True
    valid[1, :3 * W // 4] = False
    valid[1, -2] = True
    valid[-1] = False
    return q, kw, vw, valid


def blocks(W, n):
    return [(r * W // n, (r + 1) * W // n) for r in range(n)]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunks", [1, 3])
def test_swa_partial_states_merge_to_jax(shape, n, chunks):
    """Each block's ``ref.swa_decode_partial`` (its window cut into
    ``chunks``), concatenated block after block and merged by
    ``ref.merge_states`` (``ops.swa_combine`` on the CPU), equals
    ``swa_decode_attention`` over the whole window: the JAX package's
    ref and the reference's ``decode_attention``, within 1e-6."""
    b, h, kvh, dh, W = shape
    q, kw, vw, valid = inputs(W + n, *shape)
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    scale = 1.0 / np.sqrt(dh)
    T = torch.as_tensor
    parts = [ref.swa_decode_partial(T(q), T(kw[:, lo:hi]), T(vw[:, lo:hi]),
                                    T(bias[:, lo:hi]), scale, splits=chunks)
             for lo, hi in blocks(W, n)]
    part = torch.cat(parts, dim=1)
    assert part.shape == (b * h, n * chunks, dh + 2)
    got = ops.swa_combine(part, torch.float32).reshape(b, h, dh).numpy()
    want = np.asarray(jref.swa_decode_attention(
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(vw), jnp.asarray(bias),
        scale))
    dec = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kw),
                                jnp.asarray(vw), kv_valid=jnp.asarray(valid)))
    assert rel(got, want) <= TOL and rel(got, dec) <= TOL
    # row 1's first block holds no key (m = -1e30: it weighs nothing);
    # the empty row is V's mean
    assert (parts[0].reshape(b, h, chunks, -1)[1, ..., 0] == -1e30).all()
    mean = vw[-1].mean(0).repeat(h // kvh, axis=0)
    np.testing.assert_allclose(got[-1], mean, rtol=0,
                               atol=TOL * np.abs(mean).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [2, 4])
def test_decode_partial_states_merge_to_jax(shape, n):
    """``attention.decode_partial`` over each block (the full and cross
    caches' state, its mask the block's) merged in block order equals
    the reference's ``decode_attention`` over every key within 1e-6;
    MLA's absorbed decode merges its states through the same
    ``merge_states``."""
    b, h, kvh, dh, W = shape
    q, kw, vw, valid = inputs(2 * W + n, *shape)
    T = torch.as_tensor
    states = [A.decode_partial(T(q), T(kw[:, lo:hi]), T(vw[:, lo:hi]),
                               kv_valid=T(valid[:, lo:hi]))
              for lo, hi in blocks(W, n)]
    got = ref.merge_states(torch.stack(states, dim=-2)).numpy()
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kw),
                                 jnp.asarray(vw), kv_valid=jnp.asarray(valid)))
    assert got.shape == (b, h, dh)
    assert rel(got, want) <= TOL
    whole = ref.merge_states(A.decode_partial(
        T(q), T(kw), T(vw), kv_valid=T(valid))[..., None, :]).numpy()
    assert rel(whole, want) <= TOL


def _ctx(mesh, index=0, batch_cut=False):
    sizes = dict(zip(("data", "model"), mesh))
    stub = SimpleNamespace(shape=sizes, axis_names=("data", "model"),
                           index=lambda axes: index)
    return DistCtx(mesh=stub, dp=("data",), batch_cut=batch_cut)


@pytest.mark.parametrize("mesh", [(2, 1), (4, 2)])
def test_seq_block_cuts_the_sequence_in_shard_order(mesh):
    """seq_block: where B does not divide over data and n does, rank i's
    block is [i n / dp, (i + 1) n / dp); whole where B divides, where
    the batch is cut, where n does not divide, or without a mesh."""
    dp = mesh[0]
    for i in range(dp):
        assert SH.seq_block(_ctx(mesh, i), 1, 8 * dp) == (8 * i, 8 * i + 8)
        assert SH.seq_block(_ctx(mesh, i), 3, 4 * dp) == (4 * i, 4 * i + 4)
        assert SH.seq_block(_ctx(mesh, i), dp, 8 * dp) is None
        assert SH.seq_block(_ctx(mesh, i, True), 1, 8 * dp) is None
        assert SH.seq_block(_ctx(mesh, i), 1, 8 * dp + 1) is None
    assert SH.seq_block(None, 1, 8) is None
    assert SH.seq_block(_ctx((1, 2)), 1, 8) is None


def test_write_rows_writes_only_the_block_holding_the_row():
    """write_rows: each of two blocks of 4 rows writes the rows that
    fall in it and leaves the others as they were."""
    rows = torch.tensor([1, 6, 4])
    val = torch.arange(3 * 2, dtype=torch.float32).reshape(3, 2) + 10
    for lo in (0, 4):
        C = torch.full((3, 4, 2), -1.0)
        A.write_rows(C, rows, val, lo)
        want = torch.full((3, 4, 2), -1.0)
        for b, r in enumerate(rows.tolist()):
            if lo <= r < lo + 4:
                want[b, r - lo] = val[b]
        assert torch.equal(C, want), lo
