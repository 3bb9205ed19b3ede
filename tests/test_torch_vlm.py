"""The vlm family in the port (InternVL2: the patch embeddings projected
by ``vis_proj`` in front of the text tokens, Model._embed_inputs in
models/model.py, the loss on the text positions only) against the JAX
package's, on the CPU: reduced internvl2-26b (2 layers, d=256, 8 heads
over 2 KV heads, SwiGLU, RMSNorm, 16 patch embeddings), the patch
embeddings drawn from a seed x 0.02 (tests/_torch_state_pair.py's
``Pair.extra``); and its sliding-window variant (the config's
``with_sliding_window``, the published model's long-context form),
whose decode runs over the ring cache through ``swa_decode`` (its plain
version on the CPU), also at InternVL2's group width of 6 query heads a
KV head.

Tolerances (the largest |difference| over the largest |reference|):
1e-5 in f32 for logits, every cache leaf, the loss and every gradient
leaf; 2e-2 in bf16 for logits and caches (tests/test_torch_model.py's);
generated tokens exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from _torch_state_pair import (Pair, check_convert_round_trip,  # noqa: E402
                               check_decode_equals_fresh_prefill,
                               check_init_cache, check_loss_and_grads,
                               check_prefill_and_decode, check_train_steps)

NAME = "internvl2-26b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The ring variant's window, and the reduced model's heads at InternVL2's
# group width (48 query heads over 8 KV heads: 6 a KV head).
W = 32
G6 = dict(n_heads=12, n_kv_heads=2, head_dim=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (many small ops; the suite's parallel workers
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _PAIRS.clear()


_PAIRS = {}


def pair(dtype="float32", **kw):
    key = (dtype, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        _PAIRS[key] = Pair(NAME, dtype, **kw)
    return _PAIRS[key]


def test_embed_inputs_put_the_projected_patches_first():
    """x = [patch_embeds @ vis_proj ; embed(tokens)], the label offset
    the patch count; vis_proj is (d, d)."""
    pr = pair()
    toks, _ = pr.tokens(2, 5, seed=0)
    extra = pr.extra(2, seed=0)
    x, offset = pr.m._embed_inputs(pr.p, {"tokens": torch.as_tensor(toks), **{
        k: torch.as_tensor(v) for k, v in extra.items()}})
    P, d = pr.cfg.encoder.n_prefix, pr.cfg.d_model
    assert offset == P and tuple(x.shape) == (2, P + 5, d)
    assert tuple(pr.p["vis_proj"].shape) == (d, d)
    assert torch.equal(x[:, :P], torch.as_tensor(extra["patch_embeds"])
                       @ pr.p["vis_proj"])
    assert torch.equal(x[:, P:], pr.p["embed"][torch.as_tensor(toks).long()])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A prefill of 16 patches and 12 text tokens for 2 prompts, then 4
    decode steps over the full cache: logits and every cache leaf against
    the JAX package; the cache updated in place."""
    ops.reset_launch_counts()
    check_prefill_and_decode(pair(dtype), 12, tol=TOL[dtype])
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("heads", [{}, G6])
def test_ring_decode_matches_jax(heads):
    """The sliding-window variant (W=32): a prefill of 16 patches and 16
    tokens (S = W, aligned: the reference's ring layout holds every
    position at its own slot), then 4 decode steps over the ring through
    the plain swa_decode (no launch on the CPU), at the reduced model's
    group width of 4 and at InternVL2's 6: logits and the ring's k / v /
    pos against the JAX package; one step equals a fresh prefill of the
    33 positions."""
    pr = pair(sliding_window=W, **heads)
    assert pr.cfg.n_heads // pr.cfg.n_kv_heads == (6 if heads else 4)
    ops.reset_launch_counts()
    check_prefill_and_decode(pr, W - pr.cfg.encoder.n_prefix,
                             tol=TOL["float32"])
    assert sum(ops.launch_counts().values()) == 0
    pr.m.decode_room = 5
    _, cache = pr.m.prefill(pr.p, {"tokens": torch.zeros(
        (2, 16), dtype=torch.int32), **{k: torch.as_tensor(v) for k, v in
                                        pr.extra(2, seed=0).items()}})
    assert sorted(cache["segments"][0]) == ["k", "pos", "v"]
    assert tuple(cache["segments"][0]["k"].shape)[2] == W
    check_decode_equals_fresh_prefill(pr, W - pr.cfg.encoder.n_prefix)


def test_init_cache_matches_jax():
    check_init_cache(pair())
    check_init_cache(pair(sliding_window=W))


def test_decode_equals_fresh_prefill():
    check_decode_equals_fresh_prefill(pair(), 12)


def test_generate_matches_jax():
    """Greedy generate: the JAX package's tokens exactly (f32, 16 patches
    and 16 tokens, 8 steps); the cache's length counts the patches."""
    pr = pair()
    toks, _ = pr.tokens(2, 16, seed=1)
    extra = pr.extra(2, seed=1)
    want = jax_generate(pr.jm, pr.jp, {"tokens": jnp.asarray(toks), **{
        k: jnp.asarray(v) for k, v in extra.items()}}, steps=8)
    stats = {}
    got = generate(pr.m, pr.p, {"tokens": toks, **extra}, steps=8,
                   stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["cache"]["len"].tolist() == [16 + 16 + 8] * 2


# ------------------------------------------------------------ training --

def test_loss_and_grads_match_jax():
    """loss = ce over the text positions (+ a zero aux) and every
    gradient leaf against jax.value_and_grad (f32), vis_proj's named."""
    pr = pair()
    toks, labels = pr.tokens(2, 12, seed=4)
    check_loss_and_grads(pr, toks, labels, ("['vis_proj']", "['embed']"),
                         extra=pr.extra(2, seed=4))


@pytest.mark.parametrize("mb,remat", [(1, False), (2, False), (1, True)])
def test_train_step_matches_jax(mb, remat):
    check_train_steps(pair(), mb, remat=remat)


def test_convert_round_trip():
    """model_params and train_state carry vis_proj (and adamw's moments
    of it) one to one (bf16, so the dtypes are checked too)."""
    state = check_convert_round_trip(pair("bfloat16"))
    assert state.params["vis_proj"].dtype == torch.bfloat16
    assert state.opt["m"]["vis_proj"].dtype == torch.float32
