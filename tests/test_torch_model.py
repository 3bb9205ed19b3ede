"""The port's LM serve path (repro_torch.models / launch.serve) against
the JAX package's, on the CPU.

The JAX parameters of a reduced config are carried across with
``convert.model_params``; the same numpy prompts go into both packages'
``prefill``, ``serve_step`` and ``generate``. Logits and caches agree
within 1e-5 of their largest magnitude in f32 (products summed in
another order), 2e-2 in bf16 (the same products, rounded to bf16 at
other places); generated tokens and MoE routing ids exactly (the routing
test asserts that the top-k / top-(k+1) probability gap exceeds 1e-4 on
its inputs, so a mismatch is a fault, not a tie).

The ring cache of a sliding-window model is the reference's layout,
fault included: ``Model._pack_cache`` stores the last W positions at
ring indices 0..W-1, while a decode step writes position p to slot
p % W, so when S % W != 0 the first step evicts the wrong key. The port
equals the JAX package there too; a test pins that both then differ
from a fresh prefill.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.launch.serve import make_prefill as jax_make_prefill  # noqa: E402
from repro.launch.serve import make_serve_step as jax_make_step  # noqa: E402
from repro.models.common import DistCtx as JaxCtx  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.utils.prng import StepGumbel  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


class Pair:
    """One reduced config built in both packages, from one set of JAX
    parameters."""

    def __init__(self, name, dtype, window=None, seed=0):
        jcfg = jax_config(name, reduced=True).replace(dtype=dtype)
        cfg = get_config(name, reduced=True).replace(dtype=dtype)
        if window is not None:
            jcfg, cfg = (jcfg.with_sliding_window(window),
                         cfg.with_sliding_window(window))
        self.cfg, self.dtype = cfg, dtype
        self.jm, self.m = jax_build(jcfg), build_model(cfg)
        self.jp = self.jm.init(jax.random.PRNGKey(seed))
        self.p = convert.model_params(
            jax.tree_util.tree_map(np.asarray, self.jp), "cpu")

    def prompts(self, S, B=2, seed=0):
        return np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, size=(B, S)).astype(np.int32)

    def jax_fns(self, room):
        self.jm.decode_room = room
        return (jax.jit(jax_make_prefill(self.jm, JaxCtx.local())),
                jax.jit(jax_make_step(self.jm, JaxCtx.local())))


_PAIRS = {}


def pair(name, dtype, window=None):
    key = (name, dtype, window)
    if key not in _PAIRS:
        _PAIRS[key] = Pair(name, dtype, window)
    return _PAIRS[key]


@pytest.fixture(scope="module", autouse=True)
def _drop_pairs():
    yield
    _PAIRS.clear()


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def assert_close(got, want, tol, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), (what, err)


def assert_cache_close(got, want, tol):
    np.testing.assert_array_equal(got["len"].numpy(), np.asarray(want["len"]))
    for g, w in zip(got["segments"], want["segments"]):
        assert sorted(g) == sorted(w)
        for key in g:
            if key == "pos":
                np.testing.assert_array_equal(g[key].numpy(),
                                              np.asarray(w[key]))
            else:
                assert_close(g[key], w[key], tol, key)


# (config, dtype, window, prompt length). Reduced Mixtral has its own
# window W=64: S=64 and S=96 both decode over the ring (96 % 64 != 0).
# Reduced Mistral-NeMo has none: the full cache, then the ring of
# with_sliding_window(64).
CASES = [("mixtral-8x7b", "float32", None, 64),
         ("mixtral-8x7b", "float32", None, 96),
         ("mixtral-8x7b", "bfloat16", None, 64),
         ("mixtral-8x7b", "bfloat16", None, 96),
         ("mistral-nemo-12b", "float32", None, 64),
         ("mistral-nemo-12b", "float32", 64, 96)]


@pytest.mark.parametrize("name,dtype,window,S", CASES)
def test_prefill_and_decode_match_jax(name, dtype, window, S):
    pr = pair(name, dtype, window)
    steps = 3
    jprefill, jstep = pr.jax_fns(steps + 1)
    pr.m.decode_room = steps + 1
    toks = pr.prompts(S)
    jl, jc = jprefill(pr.jp, {"tokens": jnp.asarray(toks)})
    tl, tc = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks)})
    tol = TOL[dtype]
    assert_close(tl, jl, tol, "prefill logits")
    assert_cache_close(tc, jc, tol)
    ring = pr.cfg.sliding_window is not None
    assert all(("pos" in seg) == ring for seg in tc["segments"])
    ops.reset_launch_counts()
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jstep(pr.jp, jc, jnp.asarray(tok))
        tl, tc = pr.m.serve_step(pr.p, tc, torch.as_tensor(tok))
        assert_close(tl, jl, tol, "decode logits")
    assert_cache_close(tc, jc, tol)
    assert sum(ops.launch_counts().values()) == 0   # CPU: plain versions


# Besides the two configs above: Qwen1.5 (QKV bias, tied embeddings)
# and Nemotron-4 (squared ReLU, LayerNorm) cover the dense family's
# other layer options.
@pytest.mark.parametrize("name,window", [("mixtral-8x7b", None),
                                         ("mistral-nemo-12b", None),
                                         ("mistral-nemo-12b", 64),
                                         ("qwen1.5-0.5b", None),
                                         ("nemotron-4-15b", None)])
def test_generate_matches_jax(name, window):
    pr = pair(name, "float32", window)
    toks = pr.prompts(64, seed=1)
    want = jax_generate(pr.jm, pr.jp, {"tokens": jnp.asarray(toks)}, steps=8)
    stats = {}
    got = generate(pr.m, pr.p, {"tokens": torch.as_tensor(toks)}, steps=8,
                   stats=stats)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(stats["logits"]) == 9 and stats["cache"]["len"].tolist() \
        == [72, 72]
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_sampled_generate_follows_its_generator():
    """Sampled decoding takes its Gumbel noise from a StepGumbel keyed by
    (seed, step): the same seed gives the same tokens, a seed or its
    source alike; another seed other tokens; every token is a vocabulary
    id; and greedy decoding ignores the key."""
    pr = pair("mixtral-8x7b", "float32")
    batch = {"tokens": torch.as_tensor(pr.prompts(64, seed=6))}
    runs = [generate(pr.m, pr.p, batch, steps=6, greedy=False, key=key)
            for key in (3, 3, StepGumbel(3), 4)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], runs[3])
    assert bool(((runs[0] >= 0) & (runs[0] < pr.cfg.vocab_size)).all())
    assert torch.equal(generate(pr.m, pr.p, batch, steps=6, key=3),
                       generate(pr.m, pr.p, batch, steps=6))
    with pytest.raises(ValueError, match="needs a key"):
        generate(pr.m, pr.p, batch, steps=2, greedy=False)


class JaxKeySchedule:
    """The JAX package's sampled-decoding noise: step i splits the key
    (``key, k = jax.random.split(key)``) and draws
    ``jax.random.gumbel(k, logits.shape, logits.dtype)``."""

    def __init__(self, key):
        self.key, self.noise = key, []

    def draw(self, step, shape, dtype, device):
        while len(self.noise) <= step:
            self.key, k = jax.random.split(self.key)
            self.noise.append(np.array(jax.random.gumbel(
                k, tuple(shape), jnp.float32)))
        assert dtype == torch.float32
        return torch.as_tensor(self.noise[step]).to(device)


@pytest.mark.parametrize("name,window", [("mixtral-8x7b", None),
                                         ("mistral-nemo-12b", 64)])
def test_sampled_generate_matches_jax(name, window):
    """Fed the Gumbel noise of the JAX key schedule, sampled decoding in
    the port gives the JAX package's tokens exactly (f32, 64-token
    prompts, 8 steps; Mistral-NeMo over a window of 64)."""
    pr = pair(name, "float32", window)
    toks = pr.prompts(64, seed=2)
    key = jax.random.PRNGKey(11)
    want = jax_generate(pr.jm, pr.jp, {"tokens": jnp.asarray(toks)},
                        steps=8, greedy=False, key=key)
    got = generate(pr.m, pr.p, {"tokens": torch.as_tensor(toks)}, steps=8,
                   greedy=False, key=JaxKeySchedule(key))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = jax_generate(pr.jm, pr.jp, {"tokens": jnp.asarray(toks)},
                          steps=8)
    assert not np.array_equal(np.asarray(want), np.asarray(greedy))


@pytest.mark.parametrize("name,window", [("mixtral-8x7b", None),
                                         ("mistral-nemo-12b", None)])
def test_init_cache_matches_jax(name, window):
    """The zeroed decode cache: the same keys, shapes, dtypes and fill
    (a ring where room exceeds the window, else a full cache)."""
    pr = pair(name, "float32", window)
    for S in (16, 200):
        want = pr.jm.init_cache(3, S)
        got = pr.m.init_cache(3, S)
        assert_cache_close(got, want, 0.0)
        for g, w in zip(got["segments"], want["segments"]):
            assert all(tuple(g[k].shape) == w[k].shape for k in g)


def test_moe_routing_ids_match_jax(monkeypatch):
    """Each MoE layer of the prefill routes every token to the same
    experts in both packages, with a top-2 / top-3 gap above 1e-4."""
    pr = pair("mixtral-8x7b", "float32")
    k = pr.cfg.moe.top_k
    jax_ids, port_ids, gaps = [], [], []

    def gap(probs):
        top = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
        return float(np.min(top[:, k - 1] - top[:, k]))

    orig_j, orig_t = jmoe._route, moe._route

    def jax_route(router_w, x2d, m):
        ids, gates, aux = orig_j(router_w, x2d, m)
        probs = jax.nn.softmax((x2d @ router_w).astype(jnp.float32), -1)
        jax.debug.callback(lambda i, p: (jax_ids.append(np.asarray(i)),
                                         gaps.append(gap(p))),
                           ids, probs, ordered=True)
        return ids, gates, aux

    def port_route(router_w, x2d, m):
        out = orig_t(router_w, x2d, m)
        port_ids.append(out[0].numpy())
        return out

    monkeypatch.setattr(jmoe, "_route", jax_route)
    monkeypatch.setattr(moe, "_route", port_route)
    toks = pr.prompts(64, seed=2)
    pr.jm.decode_room = 1
    jl, _ = jax.jit(jax_make_prefill(pr.jm, JaxCtx.local()))(
        pr.jp, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    pr.m.decode_room = 1
    pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks)})
    assert len(jax_ids) == len(port_ids) == pr.cfg.n_layers
    assert min(gaps) > 1e-4, gaps
    for j, t in zip(jax_ids, port_ids):
        np.testing.assert_array_equal(t, j)


def test_moe_route_breaks_ties_like_jax():
    """Tied router probabilities (bf16 logits tie often) go to the lower
    expert index first, as lax.top_k orders them."""
    pr = pair("mixtral-8x7b", "float32")
    m = pr.cfg.moe
    router = np.zeros((4, m.n_experts), np.float32)
    router[0, 1] = router[0, 3] = 1.0      # token 1: experts 1 and 3 tie
    router[1, 2] = 2.0                     # token 2: 2, then 0 / 1 / 3 tie
    x = np.stack([np.zeros(4), [1, 0, 0, 0], [0, 1, 0, 0]]).astype(
        np.float32)
    want = np.asarray(jmoe._route(jnp.asarray(router), jnp.asarray(x), m)[0])
    got = moe._route(torch.as_tensor(router), torch.as_tensor(x), m)[0]
    np.testing.assert_array_equal(want, [[0, 1], [1, 3], [2, 0]])
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_layer_matches_jax_with_overflow():
    """apply_moe on random tokens (capacity factor 0.5, so tokens are
    dropped) equals the JAX layer: output within 1e-5, aux loss."""
    from repro.models.moe import apply_moe as jax_apply_moe
    pr = pair("mixtral-8x7b", "float32")
    cfg = pr.cfg.replace(moe=dataclasses.replace(pr.cfg.moe,
                                                 capacity_factor=0.5))
    lp = jax.tree_util.tree_map(lambda a: a[0], pr.jp["segments"][0]["moe"])
    x = np.random.default_rng(3).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    jy, jaux = jax_apply_moe(lp, jnp.asarray(x), cfg, JaxCtx.local())
    ty, taux = moe.apply_moe(
        convert.model_params(jax.tree_util.tree_map(np.asarray, lp), "cpu"),
        torch.as_tensor(x), cfg)
    assert_close(ty, jy, 1e-5, "moe output")
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert int(np.sum(np.all(np.asarray(jy) == 0, axis=-1))) > 0  # dropped


def test_ring_decode_after_unaligned_prefill_equals_jax_fault():
    """S=70, W=64: the port's decode equals the JAX package's, and both
    differ from a fresh prefill of the S+1 tokens (the ring layout fault
    of the reference's _pack_cache, kept in the port)."""
    pr = pair("mistral-nemo-12b", "float32", 64)
    cfg = pr.cfg.replace(attn_chunk=32)
    jm = jax_build(jax_config("mistral-nemo-12b", reduced=True).replace(
        dtype="float32", attn_chunk=32).with_sliding_window(64))
    m = Model(cfg)
    toks = pr.prompts(71, seed=4)
    jm.decode_room = m.decode_room = 2
    jl, jc = jm.prefill(pr.jp, {"tokens": jnp.asarray(toks[:, :70])},
                        JaxCtx.local())
    jl1, _ = jm.serve_step(pr.jp, jc, jnp.asarray(toks[:, 70]),
                           JaxCtx.local())
    _, tc = m.prefill(pr.p, {"tokens": torch.as_tensor(toks[:, :70])})
    tl1, _ = m.serve_step(pr.p, tc, torch.as_tensor(toks[:, 70]))
    assert_close(tl1, jl1, 1e-5, "decode logits")
    fresh, _ = m.prefill(pr.p, {"tokens": torch.as_tensor(toks)})
    jfresh, _ = jm.prefill(pr.jp, {"tokens": jnp.asarray(toks)},
                           JaxCtx.local())
    assert float(np.max(np.abs(f32(tl1) - f32(fresh)))) > 1e-2
    assert float(np.max(np.abs(f32(jl1) - f32(jfresh)))) > 1e-2


def test_ring_decode_after_aligned_prefill_equals_fresh_prefill():
    """S=64=W: the ring holds positions 0..63 at their own slots, so one
    decode step equals a fresh prefill of the 65 tokens."""
    pr = pair("mistral-nemo-12b", "float32", 64)
    toks = pr.prompts(65, seed=5)
    pr.m.decode_room = 2
    _, cache = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks[:, :64])})
    assert "pos" in cache["segments"][0]
    got, _ = pr.m.serve_step(pr.p, cache, torch.as_tensor(toks[:, 64]))
    want, _ = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks)})
    assert_close(got, want, 1e-5, "decode vs fresh prefill")


def test_sharded_moe_context_is_refused():
    """A mesh context given a layer's whole expert stacks (parameters
    converted or drawn without the mesh) is refused, naming the leaf and
    the shape this rank should hold; no collective is reached."""
    from types import SimpleNamespace

    from repro_torch.models.common import DistCtx
    pr = pair("mixtral-8x7b", "float32")
    m = pr.cfg.moe
    stub = SimpleNamespace(shape={"data": 1, "model": 2},
                           index=lambda axes: 0, size=lambda axes: 2)
    lp = {k: v[0] for k, v in pr.p["segments"][0]["moe"].items()}
    want = (m.n_experts, pr.cfg.d_model, m.d_expert // 2)
    with pytest.raises(ValueError, match=r"moe\.w1 .*" + re.escape(
            str(want))):
        moe.apply_moe(lp, torch.zeros((1, 2, pr.cfg.d_model)), pr.cfg,
                      DistCtx(mesh=stub))


def ring_fault_report():
    """For reduced Mistral-NeMo with_sliding_window(64) (f32, attention
    chunks of 32): the largest |logit| difference between one decode
    step after a prefill of S tokens and a fresh prefill of the S + 1
    tokens, in both packages, for S = 64, 70, 128, and what S = 40 (a
    prompt shorter than the window, with room past it) raises."""
    jm = jax_build(jax_config("mistral-nemo-12b", reduced=True).replace(
        dtype="float32", attn_chunk=32).with_sliding_window(64))
    m = Model(get_config("mistral-nemo-12b", reduced=True).replace(
        dtype="float32", attn_chunk=32).with_sliding_window(64))
    jp = jm.init(jax.random.PRNGKey(0))
    p = convert.model_params(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    for S in (64, 70, 128, 40):
        toks = rng.integers(0, m.cfg.vocab_size, size=(2, S + 1)).astype(
            np.int32)
        jm.decode_room = m.decode_room = 32
        out = [f"S={S}:"]
        for label, run in (
                ("jax", lambda: _jax_gap(jm, jp, toks)),
                ("port", lambda: _port_gap(m, p, toks))):
            try:
                gap, scale = run()
                out.append(f"{label} max|d logit| {gap:.3g} (logits up to "
                           f"{scale:.3g})")
            except Exception as e:  # the S < W fault raises
                out.append(f"{label} raises {type(e).__name__}: "
                           f"{str(e).splitlines()[0][:90]}")
        print(" ".join(out))


def _jax_gap(jm, jp, toks):
    ctx = JaxCtx.local()
    _, c = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :-1])}, ctx)
    got, _ = jm.serve_step(jp, c, jnp.asarray(toks[:, -1]), ctx)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, ctx)
    return (float(np.max(np.abs(f32(got) - f32(want)))),
            float(np.max(np.abs(f32(want)))))


def _port_gap(m, p, toks):
    _, c = m.prefill(p, {"tokens": torch.as_tensor(toks[:, :-1])})
    got, _ = m.serve_step(p, c, torch.as_tensor(toks[:, -1]))
    want, _ = m.prefill(p, {"tokens": torch.as_tensor(toks)})
    return (float(np.max(np.abs(f32(got) - f32(want)))),
            float(np.max(np.abs(f32(want)))))


if __name__ == "__main__":
    # python tests/test_torch_model.py: the ring layout fault, measured.
    ring_fault_report()
