"""The Zamba2 hybrid in the port (models/mamba.py, the mamba segments of
models/transformer.py, the hybrid family of models/model.py with its
weight-tied shared attention block) against the JAX package's, on the
CPU: reduced zamba2-1.2b at 5 layers in groups of 2 (two groups and a
remainder group of one, so three uses of the shared block; d=128,
Mamba2 heads of 32 over a state of 16, chunks of 16). Tolerances:
tests/_torch_state_pair.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.mamba as jmamba  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models.common import DistCtx as JaxCtx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.train import _value_and_grad  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils import tree  # noqa: E402
from _torch_state_pair import (FN_TOL, Pair, as_np,  # noqa: E402
                               check_convert_round_trip,
                               check_decode_equals_fresh_prefill,
                               check_init_cache, check_loss_and_grads,
                               check_prefill_and_decode, check_train_steps,
                               max_rel, to_jax, to_torch, torch_batch)
from test_torch_model import JaxKeySchedule  # noqa: E402

NAME = "zamba2-1.2b"
LAYERS = dict(n_layers=5, hybrid_attn_every=2)


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
    kw = {**LAYERS, **kw}
    key = (dtype, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        _PAIRS[key] = Pair(NAME, dtype, **kw)
    return _PAIRS[key]


def ssd_inputs(B, S, H, P, N, seed):
    """tests/test_seq_mixers.py's draws for the SSD recurrence, in
    numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P))
    Bv = rng.normal(size=(B, S, N)) * 0.5
    Cv = rng.normal(size=(B, S, N)) * 0.5
    dt = np.logaddexp(rng.normal(size=(B, S, H)), 0.0)
    loga = np.clip(-np.exp(rng.normal(size=(B, S, H)) * 0.3) * dt, -8.0,
                   -1e-6)
    D = np.ones((H,)) * 0.5
    h0 = rng.normal(size=(B, H, P, N)) * 0.1
    return [a.astype(np.float32) for a in (xh, Bv, Cv, dt, loga, D, h0)]


def test_plan_segments_matches_jax():
    """Groups of hybrid_attn_every Mamba2 layers and a remainder group:
    5 layers in groups of 2, and the full config's 38 in groups of 6."""
    from repro.models.transformer import plan_segments as jax_plan
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import plan_segments
    from repro.configs.base import get_config as jax_config
    for kw in (LAYERS, {}):
        got = plan_segments(get_config(NAME, reduced=True).replace(**kw))
        want = jax_plan(jax_config(NAME, reduced=True).replace(**kw))
        assert [(s.kind, s.n_layers) for s in got] == \
            [(s.kind, s.n_layers) for s in want]
    full = plan_segments(get_config(NAME))
    assert [s.n_layers for s in full] == [6] * 6 + [2]
    assert all(s.kind == "mamba" for s in full)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 64, 2, 8, 4, 16),
                                             (1, 96, 3, 4, 8, 32)])
def test_ssd_recurrences_match_jax(B, S, H, P, N, chunk):
    """ssd_scan and ssd_chunked (f32) against the JAX package's at
    tests/test_seq_mixers.py's shapes, within 1e-5; and the port's
    chunked form against its own scan within that file's 2e-3."""
    ins = ssd_inputs(B, S, H, P, N, seed=S + N)
    jins = [jnp.asarray(a) for a in ins]
    tins = [torch.as_tensor(a) for a in ins]
    y_scan, h_scan = mamba.ssd_scan(*tins)
    y_chunk, h_chunk = mamba.ssd_chunked(*tins, chunk)
    jy, jh = jmamba.ssd_scan(*jins)
    assert max_rel(y_scan, jy) <= 1e-5 and max_rel(h_scan, jh) <= 1e-5
    jy, jh = jmamba.ssd_chunked(*jins, chunk)
    assert max_rel(y_chunk, jy) <= 1e-5 and max_rel(h_chunk, jh) <= 1e-5
    np.testing.assert_allclose(y_chunk.numpy(), y_scan.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(h_chunk.numpy(), h_scan.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert torch.equal(tins[-1], torch.as_tensor(ins[-1]))   # h0 untouched


def test_gates_match_jax_across_softplus_threshold():
    """_gates with dt_raw + dt_bias on both sides of +-20 (where
    torch's softplus would switch to x; the reference's logaddexp(x, 0)
    does not) and past both clips of dt and of A dt."""
    pr = pair()
    mix_j = jax.tree_util.tree_map(lambda a: a[0],
                                   pr.jp["segments"][0]["mix"])
    H = mix_j["dt_bias"].shape[0]
    A_log = np.linspace(-9.0, 5.0, H).astype(np.float32)
    mix_j = {**mix_j, "A_log": jnp.asarray(A_log)}
    mix = convert.model_params(as_np(mix_j), "cpu")
    x = np.concatenate([np.linspace(-40.0, 40.0, 161),
                        [-20.5, -20.0, -19.5, 19.5, 20.0, 20.5, 1e-3, -9.3]])
    dt_raw = np.broadcast_to(x[:, None], (x.size, H)).astype(np.float32)
    dt_raw = dt_raw.reshape(1, x.size, H) + 1.0     # minus dt_bias = -1
    dt, loga = mamba._gates(mix, torch.as_tensor(dt_raw))
    jdt, jloga = jmamba._gates(mix_j, jnp.asarray(dt_raw))
    assert max_rel(dt, jdt) <= 1e-6 and max_rel(loga, jloga) <= 1e-6
    assert float(dt.min()) == pytest.approx(1e-4)
    assert float(dt.max()) == 10.0
    assert float(loga.min()) == -8.0
    assert float(loga.max()) == pytest.approx(-1e-6)
    # The gradient through both clips and the softplus, against jax.grad.
    w = np.random.default_rng(0).normal(size=(2,) + dt_raw.shape).astype(
        np.float32)
    jg = jax.grad(lambda r: jnp.sum(sum(
        a * b for a, b in zip(jmamba._gates(mix_j, r), w))))(
            jnp.asarray(dt_raw))
    xt = torch.as_tensor(dt_raw).requires_grad_(True)
    torch.sum(sum(a * torch.as_tensor(b) for a, b in
                  zip(mamba._gates(mix, xt), w))).backward()
    assert max_rel(xt.grad, jg) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_layer_functions_match_jax(dtype):
    """One layer's functions alone: _split_in, _causal_conv with a
    nonzero conv state (the new state its last K-1 rows), mamba2_block
    (chunked at S = 32, the scan at S = 37) from a nonzero state, and
    init_mamba_state (the JAX functions jitted)."""
    pr = pair(dtype)
    cfg, jcfg, tol = pr.cfg, pr.jcfg, FN_TOL[dtype]
    mix_j = jax.tree_util.tree_map(lambda a: a[1],
                                   pr.jp["segments"][1]["mix"])
    mix = convert.model_params(as_np(mix_j), "cpu")
    d, d_inner, H, P, N = mamba._dims(cfg)
    assert mamba._dims(cfg) == jmamba._dims(jcfg)
    K = cfg.ssm.conv_width
    j_split = jax.jit(lambda p, x: jmamba._split_in(p, x, jcfg))
    j_conv = jax.jit(jmamba._causal_conv)
    j_block = jax.jit(lambda p, x, st: jmamba.mamba2_block(p, x, st, jcfg,
                                                           JaxCtx.local()))
    rng = np.random.default_rng(2)
    for S in (32, 37):
        x = rng.normal(size=(2, S, d)).astype(np.float32)
        conv = rng.normal(size=(2, K - 1, d_inner + 2 * N)).astype(np.float32)
        h0 = (rng.normal(size=(2, H, P, N)) * 0.1).astype(np.float32)
        xj, xt = to_jax(x, jcfg.dtype), to_torch(x, dtype)
        cj, ct = to_jax(conv, jcfg.dtype), to_torch(conv, dtype)
        got = mamba._split_in(mix, xt, cfg)
        want = j_split(mix_j, xj)
        for g, w in zip(got, want):
            assert max_rel(g, w) <= tol
        xbc = to_torch(np.asarray(want[1], np.float32), dtype)
        out, ns = mamba._causal_conv(xbc, ct, mix["conv_w"], mix["conv_b"])
        jout, jns = j_conv(want[1], cj, mix_j["conv_w"], mix_j["conv_b"])
        assert out.dtype == pr.m.dtype and max_rel(out, jout) <= tol
        assert max_rel(ns, jns) == 0.0 and tuple(ns.shape) == (2, K - 1,
                                                               d_inner + 2 * N)
        y, st = mamba.mamba2_block(mix, xt, {"h": torch.as_tensor(h0),
                                            "conv": ct}, cfg)
        jy, jst = j_block(mix_j, xj, {"h": jnp.asarray(h0), "conv": cj})
        assert y.dtype == pr.m.dtype and max_rel(y, jy) <= tol, S
        assert st["h"].dtype == torch.float32
        assert max_rel(st["h"], jst["h"]) <= tol
        assert max_rel(st["conv"], jst["conv"]) <= tol
    got = mamba.init_mamba_state(3, cfg, pr.m.dtype, 2)
    want = jmamba.init_mamba_state(3, jcfg, jnp.dtype(dtype), 2)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not bool(got[key].any())


# ------------------------------------------------------------- serving --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 37])
def test_prefill_and_decode_match_jax(dtype, S):
    """A chunked (S = 32) and a scan (S = 37) prefill, then 4 decode
    steps: logits, every Mamba2 state leaf and every group's shared-block
    k / v against the JAX package; the cache updated in place. No kernel
    is launched on the CPU (no sliding window: the shared block decodes
    over its full cache)."""
    pr = pair(dtype)
    assert pr.cfg.sliding_window is None
    ops.reset_launch_counts()
    check_prefill_and_decode(pr, S)
    assert sum(ops.launch_counts().values()) == 0


def test_init_cache_matches_jax():
    pr = pair()
    check_init_cache(pr)
    cache = pr.m.init_cache(2, 10)
    assert len(cache["shared"]) == len(pr.m.segments) == 3
    assert tuple(cache["shared"][0]["k"].shape) == (
        1, 2, 11, pr.cfg.n_kv_heads, pr.cfg.hd)


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
    assert tuple(stats["cache"]["shared"][2]["v"].shape)[2] == 48 + 9


# ------------------------------------------------------------ training --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """loss = ce (+ a zero aux) and every gradient, the shared block's
    (summed over its three uses) and the f32 A_log / D / dt_bias
    included, against jax.value_and_grad, over a chunked sequence of 32
    tokens."""
    pr = pair(dtype)
    toks, labels = pr.tokens(2, 32, seed=4)
    g = check_loss_and_grads(pr, toks, labels, "['shared_block']['attn']")
    assert g["segments"][0]["mix"]["A_log"].dtype == torch.float32


def test_remat_recomputes_the_same_gradients():
    """With cfg.remat each Mamba2 layer is recomputed in the backward
    (the shared block is not, as in the reference): the same loss and
    gradients, bit for bit."""
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
    """model_params and train_state carry the mamba mix dict (its f32
    A_log, D and dt_bias in a bf16 model) and the unstacked
    shared_block one to one."""
    pr = pair("bfloat16")
    state = check_convert_round_trip(pr)
    mix = state.params["segments"][0]["mix"]
    assert {mix[k].dtype for k in ("A_log", "D", "dt_bias")} == {
        torch.float32}
    assert mix["in_proj"].dtype == torch.bfloat16
    shared = state.params["shared_block"]
    assert shared["attn"]["wq"].dim() == 2          # not stacked
    assert sorted(state.opt["m"]["shared_block"]) == sorted(shared)
    # The port draws the same unstacked layer for the shared block.
    own = pr.m.init(torch.Generator().manual_seed(0))
    assert own["shared_block"]["attn"]["wq"].shape == shared["attn"][
        "wq"].shape
