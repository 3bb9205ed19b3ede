"""RWKV-6 in the port (models/rwkv.py, the rwkv segment of
models/transformer.py, the ssm family of models/model.py) against the
JAX package's, on the CPU: reduced rwkv6-7b (2 layers, d=128, heads of
32, chunks of 16). Tolerances: tests/_torch_state_pair.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.rwkv as jrwkv  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models.common import DistCtx as JaxCtx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.train import _value_and_grad  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils import tree  # noqa: E402
from _torch_state_pair import (FN_TOL, Pair, as_np,  # noqa: E402
                               check_convert_round_trip,
                               check_decode_equals_fresh_prefill,
                               check_init_cache, check_loss_and_grads,
                               check_prefill_and_decode, check_train_steps,
                               max_rel, to_jax, to_torch, torch_batch)
from test_torch_model import JaxKeySchedule  # noqa: E402

NAME = "rwkv6-7b"


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


def recurrence_inputs(B, S, H, dh, seed):
    """tests/test_seq_mixers.py's draws for the recurrence, in numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.normal(size=(B, S, H, dh)) * 0.5),
                   -4.0, -1e-4).astype(np.float32)
    u = (rng.normal(size=(H, dh)) * 0.3).astype(np.float32)
    s0 = (rng.normal(size=(B, H, dh, dh)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


SEQ_SHAPES = [(2, 64, 2, 8, 16), (1, 96, 4, 16, 32), (3, 32, 1, 4, 8)]


@pytest.mark.parametrize("B,S,H,dh,chunk", SEQ_SHAPES)
def test_rwkv6_recurrences_match_jax(B, S, H, dh, chunk):
    """rwkv6_scan and rwkv6_chunked (f32) against the JAX package's at
    tests/test_seq_mixers.py's shapes, within 1e-5; and the port's
    chunked form against its own scan within that file's 2e-3."""
    ins = recurrence_inputs(B, S, H, dh, seed=S + H)
    jins = [jnp.asarray(a) for a in ins]
    tins = [torch.as_tensor(a) for a in ins]
    o_scan, s_scan = rwkv.rwkv6_scan(*tins)
    o_chunk, s_chunk = rwkv.rwkv6_chunked(*tins, chunk)
    jo, js = jrwkv.rwkv6_scan(*jins)
    assert max_rel(o_scan, jo) <= 1e-5 and max_rel(s_scan, js) <= 1e-5
    jo, js = jrwkv.rwkv6_chunked(*jins, chunk)
    assert max_rel(o_chunk, jo) <= 1e-5 and max_rel(s_chunk, js) <= 1e-5
    np.testing.assert_allclose(o_chunk.numpy(), o_scan.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(s_chunk.numpy(), s_scan.numpy(), rtol=2e-3,
                               atol=2e-3)
    # The carried state is a new tensor: the caller's s0 is untouched.
    assert torch.equal(tins[-1], torch.as_tensor(ins[-1]))


def test_rwkv6_scan_one_token_at_a_time():
    """The decode invariant: the scan one token at a time equals the
    scan over the whole sequence (tests/test_seq_mixers.py's 1e-4)."""
    r, k, v, logw, u, s0 = (torch.as_tensor(a) for a in
                            recurrence_inputs(1, 12, 2, 8, seed=0))
    full, sf = rwkv.rwkv6_scan(r, k, v, logw, u, torch.zeros_like(s0))
    s, outs = torch.zeros_like(s0), []
    for t in range(12):
        o, s = rwkv.rwkv6_scan(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                               logw[:, t:t + 1], u, s)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s, sf, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_layer_functions_match_jax(dtype):
    """One layer's functions alone: _token_shift, _time_mix_inputs (both
    decay clips), _group_norm, rwkv6_time_mix (chunked at S = 32, the
    scan at S = 37) from a nonzero state, rwkv_channel_mix and
    init_rwkv_state (the JAX functions jitted)."""
    pr = pair(dtype)
    cfg, jcfg, tol = pr.cfg, pr.jcfg, FN_TOL[dtype]
    seg = pr.jp["segments"][0]
    tm_j = jax.tree_util.tree_map(lambda a: a[1], seg["tm"])
    cm_j = jax.tree_util.tree_map(lambda a: a[1], seg["cm"])
    # A decay LoRA large enough that both clips of the log decay bite.
    tm_j = {**tm_j, "wB": tm_j["wB"] * 400.0}
    tm, cm = (convert.model_params(as_np(t), "cpu") for t in (tm_j, cm_j))
    rng = np.random.default_rng(1)
    d, dh = cfg.d_model, cfg.ssm.head_dim
    H = d // dh
    j_inputs = jax.jit(lambda p, x, sh: jrwkv._time_mix_inputs(p, x, sh,
                                                                jcfg))
    j_mix = jax.jit(lambda p, x, st: jrwkv.rwkv6_time_mix(p, x, st, jcfg,
                                                          JaxCtx.local()))
    j_cm = jax.jit(lambda p, x, sh: jrwkv.rwkv_channel_mix(p, x, sh, jcfg))
    for S in (32, 37):
        x = rng.normal(size=(2, S, d)).astype(np.float32)
        shift = rng.normal(size=(2, d)).astype(np.float32)
        s0 = (rng.normal(size=(2, H, dh, dh)) * 0.1).astype(np.float32)
        xj, xt = to_jax(x, jcfg.dtype), to_torch(x, dtype)
        sj, st = to_jax(shift, jcfg.dtype), to_torch(shift, dtype)
        assert max_rel(rwkv._token_shift(xt, st),
                       jrwkv._token_shift(xj, sj)) == 0.0
        got = rwkv._time_mix_inputs(tm, xt, st, cfg)
        want = j_inputs(tm_j, xj, sj)
        for name, g, w in zip("r k v g logw last".split(), got, want):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            assert max_rel(g, w) <= tol, (S, name)
        logw = got[4]
        # The outer clip's floor and the inner clip's -8 both bite.
        assert float(logw.min()) == -4.0
        assert float(logw.max()) == pytest.approx(-np.exp(-8.0), rel=1e-6)
        o, ns = rwkv.rwkv6_time_mix(tm, xt, {"s": torch.as_tensor(s0),
                                             "shift": st}, cfg)
        jo, jns = j_mix(tm_j, xj, {"s": jnp.asarray(s0), "shift": sj})
        assert o.dtype == pr.m.dtype and max_rel(o, jo) <= tol, S
        assert ns["s"].dtype == torch.float32
        assert max_rel(ns["s"], jns["s"]) <= tol
        assert max_rel(ns["shift"], jns["shift"]) == 0.0
        y, last = rwkv.rwkv_channel_mix(cm, xt, st, cfg)
        jy, jlast = j_cm(cm_j, xj, sj)
        assert max_rel(y, jy) <= tol and max_rel(last, jlast) == 0.0
        on = rwkv._group_norm(xt, tm["ln_x"], dh)
        jn = jrwkv._group_norm(xj, tm_j["ln_x"], dh)
        assert on.dtype == torch.float32 and max_rel(on, jn) <= tol
    got = rwkv.init_rwkv_state(3, cfg, pr.m.dtype, 2)
    want = jrwkv.init_rwkv_state(3, jcfg, jnp.dtype(dtype), 2)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not bool(got[key].any())


# ------------------------------------------------------------- serving --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 37])
def test_prefill_and_decode_match_jax(dtype, S):
    """A chunked (S = 32) and a scan (S = 37) prefill, then 4 decode
    steps: logits and every state leaf against the JAX package; the
    cache updated in place. No kernel is launched on the CPU."""
    ops.reset_launch_counts()
    check_prefill_and_decode(pair(dtype), S)
    assert sum(ops.launch_counts().values()) == 0


def test_init_cache_matches_jax():
    check_init_cache(pair())


@pytest.mark.parametrize("S", [32, 37])
def test_decode_equals_fresh_prefill(S):
    check_decode_equals_fresh_prefill(pair(), S)


@pytest.mark.parametrize("greedy", [True, False])
def test_generate_matches_jax(greedy):
    """Greedy, and sampled with the JAX key schedule's noise: the JAX
    package's tokens exactly (f32, 48-token prompts, 8 steps)."""
    pr = pair()
    toks, _ = pr.tokens(2, 48, seed=1)
    key = jax.random.PRNGKey(11)
    want = jax_generate(pr.jm, pr.jp, {"tokens": jnp.asarray(toks)}, steps=8,
                        greedy=greedy, key=None if greedy else key)
    stats = {}
    got = generate(pr.m, pr.p, {"tokens": torch.as_tensor(toks)}, steps=8,
                   greedy=greedy, key=None if greedy else JaxKeySchedule(key),
                   stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["cache"]["len"].tolist() == [56, 56]


# ------------------------------------------------------------ training --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """loss = ce (+ a zero aux) and every gradient (the time-mix's decay
    LoRA and bonus, the channel-mix, the interpolation vectors) against
    jax.value_and_grad, over a chunked sequence of 32 tokens."""
    pr = pair(dtype)
    toks, labels = pr.tokens(2, 32, seed=4)
    check_loss_and_grads(pr, toks, labels, "['tm']['wB']")


def test_remat_recomputes_the_same_gradients():
    """With cfg.remat each rwkv layer is recomputed in the backward:
    the same loss and gradients, bit for bit."""
    pr = pair()
    toks, labels = pr.tokens(2, 32, seed=5)
    outs = [_value_and_grad(build_model(pr.cfg.replace(remat=remat)), None,
                            pr.p, torch_batch(toks, labels))
            for remat in (False, True)]
    (l0, _, g0), (l1, _, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(g0), tree.leaves(g1)))


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    check_train_steps(pair(), mb)


def test_convert_round_trip():
    """model_params and train_state carry the rwkv tm / cm dicts one to
    one (bf16, so the dtypes are checked too)."""
    state = check_convert_round_trip(pair("bfloat16"))
    assert sorted(state.params["segments"][0]) == ["cm", "ln1", "ln2", "tm"]
    assert state.params["segments"][0]["tm"]["u"].dtype == torch.bfloat16
