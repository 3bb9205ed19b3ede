"""The port's per-cluster serving heads (repro_torch/models/heads.py) and
majority vote (repro_torch/fed/personalize.py) against the JAX
package's, on the same numpy inputs and the same head parameters
(carried across by convert.heads).

Head specs and errors exactly; parameter counts exactly; votes exactly
(ties to the smallest cluster, all-masked rows). Pooled predictions in
f32 within 1e-5 * max|y|; with bf16 storage within
2e-2 * max(max|y|, 1), since bf16 rounds after sums taken in another
order; empty queue slots exactly zero in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import list_archs as jax_archs  # noqa: E402
from repro.fed.personalize import majority_vote as jax_vote  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.fed.personalize import majority_vote  # noqa: E402
from repro_torch.models import heads  # noqa: E402

ARCHS = sorted(jax_archs())


def test_registry_matches_jax():
    assert list_archs() == ARCHS and len(ARCHS) == 10


def _resolve(mod, name, arch, d):
    try:
        return tuple(mod.resolve_head_spec(name, arch, d))
    except mod.HeadConfigError as e:
        return ("error", str(e))


@pytest.mark.parametrize("arch", ["ffn", "transformer"])
@pytest.mark.parametrize("name", ARCHS + ["linear", "no-such-config"])
def test_resolve_head_spec_matches_jax(name, arch):
    """The same HeadSpec (or the same HeadConfigError) at a width every
    config's head count divides (d=48) and one several do not (d=20)."""
    for d in (48, 20):
        got = _resolve(heads, name, arch, d)
        assert got == _resolve(jheads, name, arch, d), (name, arch, d)
        if got[0] != "error":
            spec = heads.resolve_head_spec(name, arch, d)
            assert heads.head_param_count(spec) == jheads.head_param_count(
                jheads.resolve_head_spec(name, arch, d))
    with pytest.raises(heads.HeadConfigError, match="head_arch"):
        heads.resolve_head_spec(name, "mlp", 48)


@pytest.mark.parametrize("name,arch", [
    ("linear", "ffn"), ("qwen1.5-0.5b", "ffn"), ("whisper-base", "ffn"),
    ("nemotron-4-15b", "ffn"), ("qwen1.5-0.5b", "transformer"),
    ("granite-3-2b", "transformer")])
def test_init_heads_layout_and_param_count(name, arch):
    """The port's own init: the JAX package's leaf names and shapes,
    (k, ...) stacked, and head_param_count parameters per head."""
    k, d = 3, 16
    spec = heads.resolve_head_spec(name, arch, d)
    p = heads.init_heads(torch.Generator().manual_seed(0), k, spec,
                         device="cpu")
    jp = jheads.init_heads(jax.random.PRNGKey(0), k,
                           jheads.resolve_head_spec(name, arch, d))
    assert dict(_shapes(p)) == dict(_shapes(jp))
    n = sum(a[0].numel() for a in _leaves(p))
    assert n == heads.head_param_count(spec)
    assert all(a.shape[0] == k for a in _leaves(p))
    # Another generator state gives other weights; zeros/ones stay.
    q = heads.init_heads(torch.Generator().manual_seed(1), k, spec,
                         device="cpu")
    assert not all(torch.equal(a, b) for a, b in zip(_leaves(p),
                                                     _leaves(q)))


def _shapes(tree, path=()):
    """(path, shape) of every leaf of a nested dict of arrays."""
    if isinstance(tree, dict):
        for key in tree:
            yield from _shapes(tree[key], path + (key,))
    else:
        yield path, tuple(tree.shape)


def _leaves(tree):
    out = []
    heads.tree_map(out.append, tree)
    return out


def _queues(seed, k, C, n, d):
    rng = np.random.default_rng(seed)
    qdata = (rng.normal(size=(k, C, n, d)) * 3).astype(np.float32)
    qmask = rng.random((k, C, n)) < 0.8
    qmask[0, 1] = False          # one empty queue slot
    qdata[0, 1] = 0.0            # (dispatch zeroes it)
    qmask[1, 0, :] = True
    return qdata, qmask


@pytest.mark.parametrize("serve_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,arch", [
    ("linear", "ffn"), ("qwen1.5-0.5b", "ffn"), ("whisper-base", "ffn"),
    ("nemotron-4-15b", "ffn"), ("qwen1.5-0.5b", "transformer"),
    ("granite-3-2b", "transformer")])
def test_apply_heads_matches_jax(name, arch, serve_dtype):
    """apply_heads on the JAX package's parameters: swiglu, tanh-gelu
    and relu2 FFNs; MHA (4/4) and GQA (8/2) attention; an all-masked
    queue slot pools to exactly zero."""
    k, C, n, d = 3, 3, 10, 32
    jspec = jheads.resolve_head_spec(name, arch, d)
    jp = jheads.init_heads(jax.random.PRNGKey(7), k, jspec)
    # Non-zero biases and norm scales, so every parameter is exercised.
    jp = jax.tree.map(lambda a: a + 0.05 * jnp.cos(
        jnp.arange(a.size, dtype=jnp.float32).reshape(a.shape)), jp)
    qdata, qmask = _queues(11, k, C, n, d)
    want = np.asarray(jheads.apply_heads(jp, jnp.asarray(qdata),
                                         jnp.asarray(qmask), jspec,
                                         serve_dtype=serve_dtype))
    spec = heads.resolve_head_spec(name, arch, d)
    got = heads.apply_heads(convert.heads(jax.tree.map(np.asarray, jp),
                                          device="cpu"),
                            torch.as_tensor(qdata), torch.as_tensor(qmask),
                            spec, serve_dtype=serve_dtype).numpy()
    assert got.shape == want.shape == (k, C, d) and got.dtype == np.float32
    peak = float(np.abs(want).max())
    atol = 1e-5 * peak if serve_dtype == "f32" else 2e-2 * max(peak, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.all(got[0, 1] == 0.0) and np.all(want[0, 1] == 0.0)
    assert np.isfinite(got).all()


def test_dot_takes_bf16_operands_to_f32():
    """The precision contract of every head product: bf16 operands give
    the f32 product of their (exactly upcast) values, never a product
    rounded to bf16."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(3, 5, 7, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(3, 16, 9)).astype(np.float32))
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    got = heads._dot(xb, wb)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 7, 9)
    want = torch.matmul(xb.float().reshape(3, 35, 16), wb.float())
    torch.testing.assert_close(got, want.reshape(3, 5, 7, 9), rtol=0, atol=0)
    assert not torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("seed", range(4))
def test_majority_vote_matches_jax(seed):
    """Random labels with masked points, exact ties (first max wins) and
    an all-masked row."""
    rng = np.random.default_rng(seed)
    k = 6
    labels = rng.integers(-1, k, size=(12, 9)).astype(np.int32)
    labels[0] = [2, 2, 4, 4, -1, -1, 1, 5, 3]     # tie 2/4 -> 2
    labels[1] = -1                                # all masked -> 0
    labels[2] = [5, 5, 0, 0, 1, 1, -1, -1, -1]    # three-way tie -> 0
    got = majority_vote(torch.as_tensor(labels), k)
    want = np.asarray(jax_vote(jnp.asarray(labels), k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:3].tolist() == [2, 0, 0]
