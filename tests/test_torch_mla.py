"""DeepSeek-V3 in the port (MLA attention with its absorbed latent
decode, the MTP head, the leading dense segment, top-k routing over many
experts, adafactor) against the JAX package's, on the CPU.

The JAX parameters of the reduced config are carried across with
``convert.model_params`` (and a JAX ``TrainState`` with
``convert.train_state``); the same numpy tokens go into both packages.
Tolerances:
- f32: logits, caches and the MLA functions within 1e-5 of their
  largest magnitude; generated tokens exactly; the loss, ``ce``,
  ``aux`` and ``mtp_ce`` within 1e-5 relative; each gradient leaf within
  1e-5 of its largest magnitude; after 3 adafactor train steps the loss
  and grad norm within 1e-5 relative and every parameter within 1e-5 of
  its leaf's largest magnitude plus 1e-6 (the same products, summed in
  another order).
- bf16: logits and caches within 2e-2 of their largest magnitude; the
  loss within 1e-3 relative, each gradient leaf within 5e-2 of its
  largest magnitude and 2e-2 of its norm. The router is scaled x30 and
  the test asserts that both packages route every token alike (at the
  init's scale bf16 router logits tie within one rounding).
- A decode step equals a fresh prefill of the S + 1 tokens within 1e-5
  (f32) only where no MoE entry is dropped: at 4 experts, top-2, the
  decode step's C = ceil(2 * 2 / 4 * 1.5) = 2 slots an expert, so the
  test takes a capacity factor of n_experts (C >= the tokens).
- The top_k = 8 variant (16 experts): the plan (experts, ranks, keep,
  the queues) exactly, the layer's output within 1e-5, prefill logits
  and the loss's gradients as above; its routing asserts a top-8 /
  top-9 probability gap above 1e-6 (some 100x the f32 rounding of a
  probability of 0.03), so a mismatch is a fault, not a tie.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as jattn  # noqa: E402
import repro.models.moe as jmoe  # noqa: E402
import repro.optim as joptim  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.launch.serve import make_prefill as jax_make_prefill  # noqa: E402
from repro.launch.serve import make_serve_step as jax_make_step  # noqa: E402
from repro.launch.train import TrainState as JaxTrainState  # noqa: E402
from repro.launch.train import make_train_step as jax_train_step  # noqa: E402
from repro.models.common import DistCtx as JaxCtx  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.train import _value_and_grad  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils import tree  # noqa: E402
from test_torch_model import JaxKeySchedule  # noqa: E402

NAME = "deepseek-v3-671b"
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


def as_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def max_rel(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def moe_cfg(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


class Pair:
    """Reduced DeepSeek-V3 in both packages from one set of JAX
    parameters. ``moe`` replaces MoEConfig fields in both configs;
    ``router_scale`` multiplies the MoE routers."""

    def __init__(self, dtype="float32", router_scale=None, microbatch=None,
                 **moe_kw):
        jcfg = jax_config(NAME, reduced=True).replace(dtype=dtype)
        cfg = get_config(NAME, reduced=True).replace(dtype=dtype)
        if moe_kw:
            jcfg, cfg = moe_cfg(jcfg, **moe_kw), moe_cfg(cfg, **moe_kw)
        if microbatch is not None:
            jcfg, cfg = (jcfg.replace(microbatch=microbatch),
                         cfg.replace(microbatch=microbatch))
        self.cfg, self.jcfg, self.dtype = cfg, jcfg, dtype
        self.jm, self.m = jax_build(jcfg), build_model(cfg)
        self.jp = self.jm.init(jax.random.PRNGKey(0))
        if router_scale is not None:
            segs = []
            for seg in self.jp["segments"]:
                if "moe" in seg:
                    r = seg["moe"]["router"]
                    seg = {**seg, "moe": {**seg["moe"], "router": (
                        r.astype(jnp.float32) * router_scale).astype(
                            r.dtype)}}
                segs.append(seg)
            self.jp = {**self.jp, "segments": tuple(segs)}
        self.p = convert.model_params(as_np(self.jp), "cpu")

    def tokens(self, B, S, seed):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, size=(B, S))
        labels = rng.integers(0, self.cfg.vocab_size, size=(B, S))
        labels[:, ::5] = -1
        return toks.astype(np.int32), labels.astype(np.int32)

    def jax_fns(self, room):
        self.jm.decode_room = room
        return (jax.jit(jax_make_prefill(self.jm, JaxCtx.local())),
                jax.jit(jax_make_step(self.jm, JaxCtx.local())))


_PAIRS = {}


def pair(dtype="float32", router_scale=None, **moe_kw):
    key = (dtype, router_scale, tuple(sorted(moe_kw.items())))
    if key not in _PAIRS:
        _PAIRS[key] = Pair(dtype, router_scale, **moe_kw)
    return _PAIRS[key]


def jax_batch(toks, labels):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


def torch_batch(toks, labels):
    return {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}


def assert_cache_close(got, want, tol):
    np.testing.assert_array_equal(got["len"].numpy(), np.asarray(want["len"]))
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert sorted(g) == sorted(w) == ["latent", "rope"]
        for key in g:
            assert tuple(g[key].shape) == w[key].shape
            assert max_rel(g[key], w[key]) <= tol, key


def routing_of_both(pr, fn):
    """Every MoE layer's routing ids in each package while ``fn(which)``
    runs the JAX package ("jax") and the port ("port")."""
    got = {"jax": [], "port": []}
    jroute, route = jmoe._route, moe._route

    def jax_rec(w, x, m):
        out = jroute(w, x, m)
        jax.debug.callback(lambda ids: got["jax"].append(np.asarray(ids)),
                           out[0], ordered=True)
        return out

    def port_rec(w, x, m):
        out = route(w, x, m)
        got["port"].append(out[0].numpy())
        return out
    try:
        jmoe._route, moe._route = jax_rec, port_rec
        jax.block_until_ready(fn("jax"))
        jax.effects_barrier()
        with torch.no_grad():
            fn("port")
    finally:
        jmoe._route, moe._route = jroute, route
    return got["jax"], got["port"]


# ------------------------------------------------------- MLA functions --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_functions_match_jax(dtype):
    """_mla_q, _mla_latent, mla_self and mla_decode (absorbed form,
    against a padded latent cache) of one layer, alone."""
    pr = pair(dtype)
    cfg, jcfg = pr.cfg, pr.jcfg
    lp_j = jax.tree_util.tree_map(lambda a: a[0],
                                  pr.jp["segments"][0]["attn"])
    lp = convert.model_params(as_np(lp_j), "cpu")
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 40, cfg.d_model)) * 0.5).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jcfg.dtype), torch.as_tensor(x).to(
        pr.m.dtype)
    tol = TOL[dtype]
    for got, want in zip(attn._mla_q(lp, xt, cfg),
                         jattn._mla_q(lp_j, xj, jcfg)):
        assert max_rel(got, want) <= tol
    for got, want in zip(attn._mla_latent(lp, xt, cfg),
                         jattn._mla_latent(lp_j, xj, jcfg)):
        assert max_rel(got, want) <= tol
    got = attn.mla_self(lp, xt, cfg)
    want = jattn.mla_self(lp_j, xj, jcfg, JaxCtx.local())
    assert got.dtype == pr.m.dtype and max_rel(got, want) <= tol
    # Decode: a cache of 40 positions padded to 48, lengths 40 and 33.
    cache = attn.mla_cache_entries(lp, xt, cfg)
    lengths = np.array([40, 33], np.int32)
    lat = np.zeros((2, 48, cfg.mla.kv_lora_rank), np.float32)
    rp = np.zeros((2, 48, cfg.mla.qk_rope_dim), np.float32)
    lat[:, :40], rp[:, :40] = f32(cache["latent"]), f32(cache["rope"])
    x1 = (rng.normal(size=(2, cfg.d_model)) * 0.5).astype(np.float32)
    jc = {"latent": jnp.asarray(lat).astype(jcfg.dtype),
          "rope": jnp.asarray(rp).astype(jcfg.dtype)}
    tc = {"latent": torch.as_tensor(lat).to(pr.m.dtype),
          "rope": torch.as_tensor(rp).to(pr.m.dtype)}
    want, wc = jattn.mla_decode(lp_j, jnp.asarray(x1).astype(jcfg.dtype), jc,
                                jcfg, JaxCtx.local(),
                                lengths=jnp.asarray(lengths))
    got, gc = attn.mla_decode(lp, torch.as_tensor(x1).to(pr.m.dtype), tc,
                              cfg, lengths=torch.as_tensor(lengths))
    assert max_rel(got, want) <= tol
    assert gc["latent"] is tc["latent"]            # updated in place
    for key in ("latent", "rope"):
        assert max_rel(gc[key], wc[key]) <= tol


# ------------------------------------------------------------- serving --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill logits and the latent cache (padded to the room), then 4
    decode steps (logits, cache); in bf16 both packages route alike."""
    pr = pair(dtype, router_scale=None if dtype == "float32" else 30.0)
    steps, S = 4, 40
    jprefill, jstep = pr.jax_fns(steps + 1)
    pr.m.decode_room = steps + 1
    toks, _ = pr.tokens(2, S, seed=0)
    tol = TOL[dtype]

    def run(which):
        if which == "jax":
            return jprefill(pr.jp, {"tokens": jnp.asarray(toks)})
        return pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks)})
    if dtype == "bfloat16":
        jids, ids = routing_of_both(pr, run)
        assert len(ids) == len(jids) == 1
        assert all(np.array_equal(a, b) for a, b in zip(jids, ids))
    jl, jc = run("jax")
    tl, tc = run("port")
    assert max_rel(tl, jl) <= tol
    assert_cache_close(tc, jc, tol)
    assert tc["segments"][0]["latent"].shape[2] == S + steps + 1
    ops.reset_launch_counts()
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jstep(pr.jp, jc, jnp.asarray(tok))
        tl, tc = pr.m.serve_step(pr.p, tc, torch.as_tensor(tok))
        assert max_rel(tl, jl) <= tol
    assert_cache_close(tc, jc, tol)
    assert sum(ops.launch_counts().values()) == 0   # CPU: plain versions


def test_init_cache_matches_jax():
    pr = pair()
    for S in (16, 200):
        want = pr.jm.init_cache(3, S)
        got = pr.m.init_cache(3, S)
        assert_cache_close(got, want, 0.0)


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


def test_decode_equals_fresh_prefill_without_drops():
    """With a capacity factor of n_experts no MoE entry is dropped, so
    a decode step after a prefill of S tokens equals a fresh prefill of
    the S + 1 tokens: the absorbed latent decode against the naive
    up-projection, within 1e-5."""
    pr = pair(capacity_factor=float(get_config(NAME, reduced=True)
                                    .moe.n_experts))
    toks, _ = pr.tokens(2, 37, seed=3)
    pr.m.decode_room = 2
    _, cache = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks[:, :36])})
    got, _ = pr.m.serve_step(pr.p, cache, torch.as_tensor(toks[:, 36]))
    want, _ = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks)})
    assert max_rel(got, want) <= 1e-5


# ------------------------------------------------------------ training --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """loss = ce + aux + 0.3 mtp_ce and every gradient (the MTP block's
    and projection's included) against jax.value_and_grad."""
    pr = pair(dtype, router_scale=None if dtype == "float32" else 30.0)
    toks, labels = pr.tokens(2, 40, seed=4)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: pr.jm.loss(p, jax_batch(toks, labels), JaxCtx.local()),
        has_aux=True))(pr.jp)
    loss, met, g = _value_and_grad(pr.m, None, pr.p,
                                   torch_batch(toks, labels))
    assert sorted(met) == sorted(jmet) == ["aux", "ce", "mtp_ce"]
    ltol = 1e-5 if dtype == "float32" else 1e-3
    for got, want in ((loss, jl), *((met[k], jmet[k]) for k in met)):
        assert abs(float(got) - float(want)) <= ltol * max(
            abs(float(want)), 1e-3), (float(got), float(want))
    if dtype == "bfloat16":
        jids, ids = routing_of_both(pr, lambda which: (
            pr.jm.loss(pr.jp, jax_batch(toks, labels), JaxCtx.local())
            if which == "jax" else pr.m.loss(pr.p, torch_batch(toks, labels))))
        assert len(ids) == len(jids) == 1
        assert all(np.array_equal(a, b) for a, b in zip(jids, ids))
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(jg)]
    assert len(paths) == len(tree.leaves(g))
    assert any("mtp_block" in p for p in paths)
    for path, got, want in zip(paths, tree.leaves(g),
                               jax.tree_util.tree_leaves(jg)):
        assert got.dtype == pr.m.dtype, path
        if dtype == "float32":
            assert max_rel(got, want) <= 1e-5, path
        else:
            assert max_rel(got, want) <= 5e-2, path
            assert np.linalg.norm(f32(got) - f32(want)) <= 2e-2 * \
                np.linalg.norm(f32(want)), path


def test_mtp_gradient_reaches_its_block_and_the_embedding():
    """The MTP term's gradient reaches every MTP leaf, and with remat
    (its block recomputed in the backward) the same bits."""
    pr = pair()
    toks, labels = pr.tokens(2, 24, seed=5)
    outs = []
    for remat in (False, True):
        m = build_model(pr.cfg.replace(remat=remat))
        outs.append(_value_and_grad(m, None, pr.p,
                                    torch_batch(toks, labels)))
    (l0, _, g0), (l1, _, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(g0), tree.leaves(g1)))
    for leaf in tree.leaves({k: g0[k] for k in ("mtp_proj", "mtp_block",
                                                 "mtp_norm")}):
        assert float(leaf.abs().max()) > 0


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    """3 steps of the jitted JAX train_step with the config's adafactor
    (lr 1e-3) and of the port's, from one JAX TrainState carried by
    convert.train_state: loss, grad norm and parameters after each
    step, and the factored state after the last."""
    pr = Pair(microbatch=mb)
    assert pr.cfg.optimizer == "adafactor"
    jopt = joptim.build_optimizer("adafactor", 1e-3)
    opt = optim.build_optimizer("adafactor", 1e-3)
    jstate = JaxTrainState(pr.jp, jopt.init(pr.jp), jnp.zeros((), jnp.int32))
    state = convert.train_state(as_np(jstate), "cpu")
    assert sorted(state.opt) == ["f"]
    assert sorted(state.opt["f"]["mtp_block"]["attn"]["wq_a"]) == ["c", "r"]
    assert sorted(state.opt["f"]["mtp_block"]["attn"]["q_norm"]) == ["v"]
    jstep = jax.jit(jax_train_step(pr.jm, JaxCtx.local(), jopt))
    step = make_train_step(pr.m, None, opt)
    for i in range(3):
        toks, labels = pr.tokens(4, 24, seed=10 + i)
        jstate, jmet = jstep(jstate, jax_batch(toks, labels))
        state, met = step(state, torch_batch(toks, labels))
        assert sorted(met) == sorted(jmet)
        for key in met:
            assert abs(float(met[key]) - float(jmet[key])) <= 1e-5 * abs(
                float(jmet[key])), (i, key)
        for got, want in zip(tree.leaves(state.params),
                             jax.tree_util.tree_leaves(jstate.params)):
            err = np.max(np.abs(f32(got) - f32(want)))
            assert err <= 1e-5 * np.max(np.abs(f32(want))) + 1e-6, i
    for got, want in zip(tree.leaves(state.opt),
                         jax.tree_util.tree_leaves(jstate.opt)):
        assert max_rel(got, want) <= 1e-4


# ------------------------------------------------ top_k = 8 of 16 experts --

TOP8 = dict(n_experts=16, top_k=8)


def test_top8_plan_dispatch_and_combine_match_jax():
    """At top_k = 8 of 16 experts (capacity factor 0.75, so entries
    drop): the routing ids (top-8 / top-9 gap above 1e-6), the plan's
    experts, ranks and keep mask and the queues exactly, the combine
    within 1e-6 of its largest magnitude, and the whole layer within
    1e-5, against the JAX package's _route, _pack, _unpack and
    apply_moe."""
    cfg = moe_cfg(get_config(NAME, reduced=True).replace(dtype="float32"),
                  capacity_factor=0.75, **TOP8)
    jcfg = moe_cfg(jax_config(NAME, reduced=True).replace(dtype="float32"),
                   capacity_factor=0.75, **TOP8)
    m, jm = cfg.moe, jcfg.moe
    lp_j = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    lp_j = {**lp_j, "router": lp_j["router"] * 30.0}
    lp = convert.model_params(as_np(lp_j), "cpu")
    x = np.random.default_rng(6).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)
    x2 = x.reshape(-1, cfg.d_model)
    jids, jgates, jaux = jmoe._route(lp_j["router"], jnp.asarray(x2), jm)
    ids, gates, aux = moe._route(lp["router"], torch.as_tensor(x2), m)
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x2) @ lp_j["router"], -1), np.float64), -1)[:, ::-1]
    assert float(np.min(probs[:, 7] - probs[:, 8])) > 1e-6
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert max_rel(gates, jgates) <= 1e-6
    C = moe._capacity(x2.shape[0], m)
    assert C == jmoe._capacity(x2.shape[0], jm)
    jbuf, jflat, jpos, jkeep = jmoe._pack(jnp.asarray(x2), jids, jm, C)
    buf, plan = moe._pack(torch.as_tensor(x2), ids, m, C)
    _, _, flat_e, pos_c, keep, _ = plan
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(pos_c.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not bool(keep.all())                     # entries dropped
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    ye = np.random.default_rng(7).normal(size=tuple(buf.shape)).astype(
        np.float32)
    want = jmoe._unpack(jnp.asarray(ye), jflat, jpos, jkeep, jgates,
                        x2.shape[0], 8)
    got = moe._unpack(torch.as_tensor(ye), plan, gates, 8)
    assert max_rel(got, want) <= 1e-6
    jy, jaux = jmoe.apply_moe(lp_j, jnp.asarray(x), jcfg, JaxCtx.local())
    y, aux = moe.apply_moe(lp, torch.as_tensor(x), cfg)
    assert max_rel(y, jy) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_top8_model_matches_jax():
    """The reduced model with 16 experts at top_k = 8 (router x30):
    prefill logits and 2 decode steps, then the loss and every gradient,
    against the JAX package, routing alike in every MoE call."""
    pr = pair(router_scale=30.0, **TOP8)
    jprefill, jstep = pr.jax_fns(3)
    pr.m.decode_room = 3
    toks, labels = pr.tokens(2, 32, seed=8)
    jl, jc = jprefill(pr.jp, {"tokens": jnp.asarray(toks)})
    tl, tc = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks)})
    assert max_rel(tl, jl) <= 1e-5
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jstep(pr.jp, jc, jnp.asarray(tok))
        tl, tc = pr.m.serve_step(pr.p, tc, torch.as_tensor(tok))
        assert max_rel(tl, jl) <= 1e-5
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: pr.jm.loss(p, jax_batch(toks, labels), JaxCtx.local()),
        has_aux=True))(pr.jp)
    loss, _, g = _value_and_grad(pr.m, None, pr.p, torch_batch(toks, labels))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for got, want in zip(tree.leaves(g), jax.tree_util.tree_leaves(jg)):
        assert max_rel(got, want) <= 1e-5
