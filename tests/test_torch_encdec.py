"""The encdec family in the port (Whisper: the non-causal encoder
segment, the decoder's cross-attention in models/transformer.py, and
Model._encode / _cross_cache in models/model.py) against the JAX
package's, on the CPU: reduced whisper-base (2 encoder and 2 decoder
layers, d=128, 4 heads of 32, GeLU, LayerNorm, tied embeddings, 8
frames of encoder memory), the frame embeddings drawn from a seed x
0.02 (tests/_torch_state_pair.py's ``Pair.extra``).

Tolerances (the largest |difference| over the largest |reference|):
1e-5 in f32 for logits, every cache leaf (``ck`` / ``cv`` / ``cvalid``
included), the loss and every gradient leaf; 2e-2 in bf16 for logits
and caches (tests/test_torch_model.py's); generated tokens exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as jattn  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.train import _value_and_grad  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils import tree  # noqa: E402
from _torch_state_pair import (Pair, check_convert_round_trip,  # noqa: E402
                               check_decode_equals_fresh_prefill,
                               check_init_cache, check_loss_and_grads,
                               check_prefill_and_decode, check_train_steps,
                               max_rel, torch_batch)

NAME = "whisper-base"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def test_plan_and_parameters_match_jax():
    """The decoder is one attn_ffn segment with cross-attention, the
    encoder one non-causal segment of encoder.n_layers; each decoder
    layer adds ln_x and a GQA xattn set."""
    from repro.models.transformer import plan_segments as jax_plan
    from repro_torch.models.transformer import plan_segments
    pr = pair()
    got, want = plan_segments(pr.cfg), jax_plan(pr.jcfg)
    assert [(s.kind, s.n_layers, s.cross, s.causal) for s in got] == \
        [(s.kind, s.n_layers, s.cross, s.causal) for s in want] == \
        [("attn_ffn", 2, True, True)]
    assert pr.m._enc_spec().causal is False
    assert pr.m._enc_spec().n_layers == pr.cfg.encoder.n_layers == 2
    assert sorted(pr.p["segments"][0]) == ["attn", "ffn", "ln1", "ln2",
                                           "ln_x", "xattn"]
    assert sorted(pr.p["segments"][0]["xattn"]) == ["wk", "wo", "wq", "wv"]
    assert len(pr.p["enc_segments"]) == 1 and "xattn" not in \
        pr.p["enc_segments"][0]


@pytest.mark.parametrize("S,chunk,H,KVH,D", [(13, 4, 4, 2, 8),
                                             (1500, 512, 2, 2, 8)])
def test_non_causal_flash_attention_matches_jax(S, chunk, H, KVH, D):
    """flash_attention(causal=False) at a length that is not a multiple
    of the chunk (13 in chunks of 4; Whisper's 1500 frames in chunks of
    512, padded to 1536 keys) against the JAX package's within 1e-5 (f32)
    and against plain_attention over the S keys: the padded keys stay
    masked."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(2, S, n, D)).astype(np.float32)
               for n in (H, KVH, KVH))
    got = attention.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                    causal=False, cq=chunk, ck=chunk)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                 cq=chunk, ck=chunk)
    assert max_rel(got, want) <= 1e-5
    full = attention.plain_attention(*map(torch.as_tensor, (q, k, v)))
    assert max_rel(got, full) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A prefill of 2 prompts of 12 decoder tokens over 8 encoded frames,
    then 4 decode steps: logits and every cache leaf (the self-attention
    k / v and the encoder's ck / cv / cvalid) against the JAX package;
    the cache updated in place. No kernel is launched on the CPU."""
    pr = pair(dtype)
    ops.reset_launch_counts()
    check_prefill_and_decode(pr, 12, tol=TOL[dtype])
    assert sum(ops.launch_counts().values()) == 0
    pr.m.decode_room = 1
    _, cache = pr.m.prefill(pr.p, {"tokens": torch.zeros(
        (2, 3), dtype=torch.int32), **{k: torch.as_tensor(v) for k, v in
                                       pr.extra(2, seed=0).items()}})
    seg = cache["segments"][0]
    assert sorted(seg) == ["ck", "cv", "cvalid", "k", "v"]
    assert tuple(seg["ck"].shape) == (2, 2, 8, 4, 32)
    assert seg["cvalid"].dtype == torch.bool and bool(seg["cvalid"].all())


def test_init_cache_matches_jax():
    """The zeroed cache: a full self-attention cache and the encoder's
    keys and values for encoder.n_ctx frames, all valid."""
    check_init_cache(pair())


def test_decode_equals_fresh_prefill():
    check_decode_equals_fresh_prefill(pair(), 12)


def test_generate_matches_jax():
    """Greedy generate: the JAX package's tokens exactly (f32, prompts of
    16 decoder tokens, 8 steps)."""
    pr = pair()
    toks, _ = pr.tokens(2, 16, seed=1)
    extra = pr.extra(2, seed=1)
    want = jax_generate(pr.jm, pr.jp, {"tokens": jnp.asarray(toks), **{
        k: jnp.asarray(v) for k, v in extra.items()}}, steps=8)
    stats = {}
    got = generate(pr.m, pr.p, {"tokens": toks, **extra}, steps=8,
                   stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["cache"]["len"].tolist() == [24, 24]


def test_cross_query_bias_is_left_out_at_decode_as_in_jax():
    """The reference's cross-attention query takes the xattn bias over a
    full sequence (``_qkv``) but not at decode (``h @ wq``). With
    qkv_bias and a nonzero ``bq`` the port's decode equals the JAX
    package's, and both differ from a fresh prefill of the S + 1 tokens:
    the mis-step of the reference, kept (ROADMAP §3). Whisper's config
    has no bias, where the two agree."""
    from repro_torch import convert
    pr = pair(qkv_bias=True)
    rng = np.random.default_rng(7)
    jp = jax.tree_util.tree_map(lambda a: a, pr.jp)
    seg = dict(jp["segments"][0])
    xattn = dict(seg["xattn"])
    xattn["bq"] = jnp.asarray(rng.normal(size=xattn["bq"].shape).astype(
        np.float32))
    seg["xattn"] = xattn
    jp["segments"] = (seg,)
    p = convert.model_params(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks, _ = pr.tokens(2, 13, seed=8)
    extra = pr.extra(2, seed=8)
    tb = {k: torch.as_tensor(v) for k, v in extra.items()}
    jb = {k: jnp.asarray(v) for k, v in extra.items()}
    jprefill, jstep = pr.jax_fns(2)
    pr.m.decode_room = 2
    _, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :12]), **jb})
    jl, _ = jstep(jp, jc, jnp.asarray(toks[:, 12]))
    _, tc = pr.m.prefill(p, {"tokens": torch.as_tensor(toks[:, :12]), **tb})
    tl, _ = pr.m.serve_step(p, tc, torch.as_tensor(toks[:, 12]))
    assert max_rel(tl, jl) <= 1e-5
    fresh, _ = pr.m.prefill(p, {"tokens": torch.as_tensor(toks), **tb})
    jfresh, _ = jprefill(jp, {"tokens": jnp.asarray(toks), **jb})
    assert max_rel(fresh, jfresh) <= 1e-5
    assert max_rel(tl, fresh) > 1e-3 and max_rel(jl, jfresh) > 1e-3


# ------------------------------------------------------------ training --

def test_loss_and_grads_match_jax():
    """loss = ce (+ a zero aux) and every gradient leaf against
    jax.value_and_grad (f32), the encoder's (enc_segments, enc_norm) and
    the cross-attention's (xattn, ln_x) named among them."""
    pr = pair()
    toks, labels = pr.tokens(2, 12, seed=4)
    check_loss_and_grads(pr, toks, labels,
                         ("['enc_segments'][0]['attn']['wq']",
                          "['enc_norm']['w']", "['xattn']['wk']",
                          "['xattn']['wq']", "['ln_x']['b']"),
                         extra=pr.extra(2, seed=4))


def test_remat_reaches_the_encoder_through_every_cross_layer():
    """With cfg.remat each decoder layer is recomputed in the backward
    with the encoder's output as an argument: the same loss and
    gradients bit for bit as without, and the encoder's gradient
    nonzero; without the cross-attention's keys and values (xattn wk /
    wv at zero) the encoder's gradient is zero."""
    pr = pair()
    toks, labels = pr.tokens(2, 12, seed=5)
    batch = torch_batch(toks, labels, pr.extra(2, seed=5))
    outs = [_value_and_grad(build_model(pr.cfg.replace(remat=remat)), None,
                            pr.p, batch) for remat in (False, True)]
    (l0, _, g0), (l1, _, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(g0), tree.leaves(g1)))
    assert all(bool(a.abs().max() > 0) for a in tree.leaves(
        g1["enc_segments"]) + tree.leaves(g1["enc_norm"]))
    cut = {**pr.p, "segments": ({**pr.p["segments"][0], "xattn": {
        **pr.p["segments"][0]["xattn"],
        "wk": torch.zeros_like(pr.p["segments"][0]["xattn"]["wk"]),
        "wv": torch.zeros_like(pr.p["segments"][0]["xattn"]["wv"])}},)}
    _, _, g = _value_and_grad(build_model(pr.cfg.replace(remat=True)), None,
                              cut, batch)
    assert all(not bool(a.any()) for a in tree.leaves(g["enc_segments"]))


@pytest.mark.parametrize("mb,remat", [(1, False), (2, False), (1, True)])
def test_train_step_matches_jax(mb, remat):
    check_train_steps(pair(), mb, remat=remat)


def test_convert_round_trip():
    """model_params and train_state carry enc_segments, enc_norm, ln_x
    and xattn (and adamw's moments of them) one to one (bf16, so the
    dtypes are checked too)."""
    state = check_convert_round_trip(pair("bfloat16"))
    assert isinstance(state.params["enc_segments"], tuple)
    assert state.params["segments"][0]["xattn"]["wk"].dtype == torch.bfloat16
    assert sorted(state.opt["m"]["enc_norm"]) == ["b", "w"]
    assert tuple(state.opt["v"]["segments"][0]["xattn"]["wq"].shape) == \
        tuple(state.params["segments"][0]["xattn"]["wq"].shape)
