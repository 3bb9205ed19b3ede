"""The port's Gumbel sources (repro_torch/utils/prng.py), and the sources
that reproduce the JAX package's own k-means++ draws for the parity
tests of the other test_torch_* files.

``jax.random.categorical(key, logits)`` is ``argmax(gumbel(key) +
logits)``; the JAX package keys device z of a round by ``split(key,
Z)[z]`` and serving request rid by ``fold_in(PRNGKey(seed), rid)``, then
pick t of k-means++ by ``split(., k')[t]``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.utils.prng import GumbelSource  # noqa: E402


def _gumbel_rows(key, k_prime: int, n: int) -> np.ndarray:
    subs = jax.random.split(key, k_prime)
    return np.stack([np.asarray(jax.random.gumbel(s, (n,), jnp.float32))
                     for s in subs])


class JaxRoundGumbel(GumbelSource):
    """The draws of the JAX package's ``Session.run(key, data)`` for a
    round of Z devices: device z uses ``split(key, Z)[z]``."""

    def __init__(self, key, Z: int):
        super().__init__(0)
        self.keys = jax.random.split(key, Z)

    def draw(self, ids, k_prime, n, device):
        return torch.as_tensor(np.stack(
            [_gumbel_rows(self.keys[int(i)], k_prime, n) for i in ids]),
            device=device)


class JaxServeGumbel(GumbelSource):
    """The draws of the JAX package's serving: request rid uses
    ``fold_in(PRNGKey(seed), rid)``."""

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self.base = jax.random.PRNGKey(seed)

    def draw(self, ids, k_prime, n, device):
        return torch.as_tensor(np.stack(
            [_gumbel_rows(jax.random.fold_in(self.base, np.uint32(i)),
                          k_prime, n) for i in ids]), device=device)


def test_categorical_is_argmax_of_gumbel_plus_logits():
    """The identity the Jax*Gumbel sources rest on, in the installed
    jax: categorical(key, logits) == argmax(gumbel(key) + logits)."""
    rng = np.random.default_rng(0)
    for t in range(20):
        key = jax.random.PRNGKey(t)
        logits = jnp.asarray(rng.normal(size=(37,)) * 3, jnp.float32)
        logits = logits.at[rng.integers(0, 37, 5)].set(-jnp.inf)
        want = int(jax.random.categorical(key, logits))
        g = jax.random.gumbel(key, (37,), jnp.float32)
        assert int(jnp.argmax(g + logits)) == want


def test_default_source_keys_by_seed_and_id():
    """A request's draws depend on (seed, id) only: batching and order
    do not change them, and another seed or id gives other draws."""
    src = GumbelSource(7)
    a = src.draw([3, 5, 3], 4, 16, "cpu")
    assert a.shape == (3, 4, 16) and a.dtype == torch.float32
    torch.testing.assert_close(a[0], a[2], rtol=0, atol=0)
    torch.testing.assert_close(src.draw([5], 4, 16, "cpu")[0], a[1],
                               rtol=0, atol=0)
    assert not torch.equal(GumbelSource(8).draw([3], 4, 16, "cpu")[0], a[0])
    assert not torch.equal(a[0], a[1])
    assert torch.isfinite(a).all()


def test_default_source_is_gumbel_distributed():
    g = GumbelSource(0).draw(range(4), 8, 4096, "cpu").double()
    # Gumbel(0, 1): mean = Euler-Mascheroni, variance = pi^2 / 6.
    assert abs(float(g.mean()) - 0.5772) < 0.02
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.05


def test_jax_sources_match_jax_key_schedule():
    key = jax.random.PRNGKey(3)
    rnd = JaxRoundGumbel(key, 4).draw([2], 3, 10, "cpu")[0].numpy()
    sub = jax.random.split(jax.random.split(key, 4)[2], 3)[1]
    np.testing.assert_array_equal(
        rnd[1], np.asarray(jax.random.gumbel(sub, (10,), jnp.float32)))
    srv = JaxServeGumbel(5).draw([9], 3, 10, "cpu")[0].numpy()
    sub = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), 9), 3)[0]
    np.testing.assert_array_equal(
        srv[0], np.asarray(jax.random.gumbel(sub, (10,), jnp.float32)))
