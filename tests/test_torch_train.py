"""The port's training path (repro_torch.launch.train, optim, Model.loss,
the MoE layer's gradients) against the JAX package's, on the CPU.

The JAX parameters and train states of reduced configs are carried
across with ``convert.model_params`` / ``convert.train_state``; the same
numpy tokens and labels go into both packages. Tolerances:
- f32: the loss within 1e-5 of its magnitude; each gradient leaf within
  1e-5 of the leaf's largest magnitude (the same products, summed in
  another order); after 3 train steps the loss and grad norm within
  1e-5 relative, every parameter within 1e-5 of its leaf's largest
  magnitude plus 1e-6, with adamw at eps=1e-4: at the default 1e-8 a
  weight whose gradient is near 0 moves by lr * g / (|g| + eps), whose
  slope 1/eps turns a gradient's last-bit difference into a step of up
  to lr (a few dozen of a leaf's weights differ by 1e-5 at lr=1e-3).
  test_train_step_at_default_eps_matches_jax takes eps=1e-8 and holds
  the weights whose gradient is well above eps to that bound, the others
  to 2.01 lr a step.
- bf16 (reduced Mixtral): the loss within 1e-3 relative; each gradient
  leaf within 5e-2 of its largest magnitude and, as a whole, within
  2e-2 of its norm (bf16 rounds at other places in the two frameworks).
  The router is scaled x30 there and the test asserts that both
  packages route every token alike: at the init's scale bf16 router
  logits tie within one rounding, and a tie broken the other way moves
  an expert's gradient by far more than any tolerance.
- The MoE backward formulas (kernels/ref.py) against autograd of the
  plain forward: dx and dybuf bit for bit at top_k <= 2 (equal values);
  at top_k = 4 dx within 1e-6 of the sum of its terms' magnitudes in
  f32 (autograd adds the slots in queue order, the formula in j order);
  in bf16 the formula equals the exact sum rounded once, and autograd
  (which rounds each of its top_k - 1 additions to bf16) is within
  (top_k - 1) * 2^-8 of the terms' magnitudes; dgates within 1e-6 of sum_c
  |dout * ybuf| (another order of an f32 sum). gradcheck in f64.
- The optimizers: 3 updates within 1e-6 of each leaf's largest
  magnitude (f32 arithmetic, pow and rsqrt of two libraries).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro.optim as joptim  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch.train import TrainState as JaxTrainState  # noqa: E402
from repro.launch.train import make_train_step as jax_train_step  # noqa: E402
from repro.models.common import DistCtx as JaxCtx  # noqa: E402
from repro.models.common import cross_entropy as jax_ce  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm_stream import synthetic_batches  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.train import _value_and_grad  # noqa: E402
from repro_torch.launch.train import make_train_step, train_loop  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils import tree  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these steps are many small ops, which the
    suite's parallel workers slow many times over when each runs a pool
    of threads on the shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def max_rel(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def jax_leaves(t):
    return jax.tree_util.tree_leaves(t)


def as_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ------------------------------------------------------------ the loss --

@pytest.mark.parametrize("case", ["masked", "unmasked", "all_masked"])
def test_cross_entropy_matches_jax(case):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = {"masked": rng.random((3, 7)) < 0.6, "unmasked": None,
            "all_masked": np.zeros((3, 7), bool)}[case]
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                        None if mask is None else torch.as_tensor(mask))
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                  None if mask is None else jnp.asarray(mask))
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1)
    if case == "all_masked":
        assert float(got) == 0.0


class Pair:
    """One reduced config in both packages, from one set of JAX
    parameters (``router_scale`` multiplies the MoE routers)."""

    def __init__(self, name, dtype="float32", window=None, cf=None,
                 microbatch=None, router_scale=None):
        jcfg = jax_config(name, reduced=True).replace(dtype=dtype)
        cfg = get_config(name, reduced=True).replace(dtype=dtype)
        if window is not None:
            jcfg, cfg = (jcfg.with_sliding_window(window),
                         cfg.with_sliding_window(window))
        if cf is not None:
            jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                        capacity_factor=cf))
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=cf))
        if microbatch is not None:
            jcfg, cfg = (jcfg.replace(microbatch=microbatch),
                         cfg.replace(microbatch=microbatch))
        self.cfg = cfg
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

    def batch(self, B=2, S=48, seed=0):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, size=(B, S))
        labels = rng.integers(0, self.cfg.vocab_size, size=(B, S))
        labels[:, ::5] = -1
        return toks.astype(np.int32), labels.astype(np.int32)


def torch_batch(toks, labels):
    return {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}


def jax_batch(toks, labels):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


def routing_of_both(pr, toks, labels):
    """Every MoE layer's routing ids in each package on this batch (the
    JAX ids read out of the scanned layers by an ordered callback)."""
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
        jax.block_until_ready(pr.jm.loss(pr.jp, jax_batch(toks, labels),
                                         JaxCtx.local()))
        jax.effects_barrier()
        with torch.no_grad():
            pr.m.loss(pr.p, torch_batch(toks, labels))
    finally:
        jmoe._route, moe._route = jroute, route
    return got["jax"], got["port"]


LOSS_CASES = [("granite-3-2b", "float32", None, None, None),
              ("mistral-nemo-12b", "float32", 64, None, None),
              ("qwen1.5-0.5b", "float32", None, None, None),
              ("mixtral-8x7b", "float32", None, 0.5, None),
              ("mixtral-8x7b", "bfloat16", None, 0.5, 30.0)]


@pytest.mark.parametrize("name,dtype,window,cf,router_scale", LOSS_CASES)
def test_loss_and_grads_match_jax(name, dtype, window, cf, router_scale):
    pr = Pair(name, dtype, window, cf, router_scale=router_scale)
    toks, labels = pr.batch()
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: pr.jm.loss(p, jax_batch(toks, labels), JaxCtx.local()),
        has_aux=True)(pr.jp)
    loss, met, g = _value_and_grad(pr.m, None, pr.p,
                                   torch_batch(toks, labels))
    if cf is not None:
        C = moe._capacity(toks.size, pr.cfg.moe)
        assert C * pr.cfg.moe.n_experts < toks.size * pr.cfg.moe.top_k
    ltol = 1e-5 if dtype == "float32" else 1e-3
    for got, want in ((loss, jl), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        assert abs(float(got) - float(want)) <= ltol * max(
            abs(float(want)), 1e-3), (float(got), float(want))
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(jg)]
    assert len(paths) == len(tree.leaves(g))
    if dtype == "bfloat16":
        jids, ids = routing_of_both(pr, toks, labels)
        assert len(ids) == len(jids) == pr.cfg.n_layers
        assert all(np.array_equal(a, b) for a, b in zip(jids, ids))
    for path, got, want in zip(paths, tree.leaves(g), jax_leaves(jg)):
        assert got.dtype == pr.m.dtype
        if dtype == "float32":
            assert max_rel(got, want) <= 1e-5, path
        else:
            diff = f32(got) - f32(want)
            assert max_rel(got, want) <= 5e-2, path
            assert np.linalg.norm(diff) <= 2e-2 * np.linalg.norm(
                f32(want)), path


def test_remat_gives_the_same_bits():
    """cfg.remat recomputes each layer in the backward: the same loss
    and gradients, bit for bit."""
    pr = Pair("mixtral-8x7b", cf=0.5)
    toks, labels = pr.batch(seed=3)
    outs = []
    for remat in (False, True):
        m = build_model(pr.cfg.replace(remat=remat))
        outs.append(_value_and_grad(m, None, pr.p, torch_batch(toks, labels)))
    (l0, _, g0), (l1, _, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(g0), tree.leaves(g1)))


def test_moe_layer_gradient_reaches_router_and_experts():
    """Through the dispatch and combine Functions, the loss's gradient
    reaches the router and every expert weight of every MoE layer."""
    pr = Pair("mixtral-8x7b", cf=0.5)
    toks, labels = pr.batch(seed=4)
    _, _, g = _value_and_grad(pr.m, None, pr.p, torch_batch(toks, labels))
    for seg in g["segments"]:
        for name in ("router", "w1", "w2", "w3"):
            per_layer = seg["moe"][name].flatten(1).abs().amax(dim=1)
            assert bool((per_layer > 0).all()), name


# ------------------------------------------- the MoE backward formulas --

def routing(seed, T, d, E, top_k, cf, dtype):
    """(x, plan, gates, C) of a random routing of T tokens among E
    experts (moe._route and moe._plan), in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    m = dataclasses.replace(get_config("mixtral-8x7b", reduced=True).moe,
                            n_experts=E, top_k=top_k, capacity_factor=cf)
    x = torch.randn(T, d, generator=g).to(dtype)
    router = torch.randn(d, E, generator=g).to(dtype)
    ids, gates, _ = moe._route(router, x, m)
    C = moe._capacity(T, m)
    return x, moe._plan(ids, m, C), gates, C, m


BWD_CASES = [(1, 1.0), (2, 0.5), (2, 1.25), (4, 0.75)]


@pytest.mark.parametrize("top_k,cf", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_backward_formulas_match_autograd(top_k, cf, dtype):
    T, d, E = 40, 12, 6
    x, plan, gates, C, m = routing(top_k * 10 + int(cf * 8), T, d, E, top_k,
                                   cf, dtype)
    src, valid, flat_e, pos_c, keep, src_entry = plan
    S = E * C
    slot = (flat_e * C + pos_c).to(torch.int32)
    g = torch.Generator().manual_seed(7)
    dbuf = torch.randn(S, d, generator=g).to(dtype)
    ybuf = torch.randn(S, d, generator=g).to(dtype)
    dout = torch.randn(T, d, generator=g)

    # dispatch: autograd of the plain gather against the formula.
    xr = x.clone().requires_grad_(True)
    want_dx, = torch.autograd.grad(ref.moe_dispatch(xr, src, valid), xr,
                                   dbuf)
    got_dx = ref.moe_dispatch_bwd(dbuf, slot, keep, T, top_k, dtype)
    assert got_dx.dtype == dtype
    if top_k <= 2:
        assert torch.equal(got_dx, want_dx)
    else:
        exact = ref.moe_dispatch_bwd(dbuf.double(), slot, keep, T, top_k)
        if dtype == torch.float32:
            terms = ref.sequential_combine(dbuf.abs(), slot, keep.float(),
                                           top_k)
            assert bool(((got_dx - want_dx).abs() <= 1e-6 * terms).all())
        else:
            # The formula rounds the exact sum once; autograd rounds
            # each of its top_k - 1 additions to bf16 (unit 2^-8).
            terms = ref.sequential_combine(dbuf.double().abs(), slot,
                                           keep.double(), top_k)
            assert torch.equal(got_dx, exact.to(dtype))
            assert bool(((want_dx.double() - exact).abs()
                         <= (top_k - 1) * 2.0 ** -8 * terms).all())

    # combine: autograd of the plain combine, gates through the keep
    # mask as in the layer, against the formula.
    yr = ybuf.clone().requires_grad_(True)
    gr = gates.reshape(-1).clone().requires_grad_(True)
    w = torch.where(keep, gr, 0.0)
    want_dy, want_dg = torch.autograd.grad(
        ref.moe_combine(yr, slot, w, top_k), (yr, gr), dout)
    got_dy, got_dg = ref.moe_combine_bwd(dout, ybuf, src_entry, valid,
                                         w.detach(), top_k)
    assert got_dy.dtype == dtype and torch.equal(got_dy, want_dy)
    assert bool((got_dg[~keep] == 0).all())
    terms = ref.moe_combine_bwd(dout.abs(), ybuf.abs(), src_entry, valid,
                                w.detach(), top_k)[1]
    assert bool(((got_dg - want_dg).abs() <= 1e-6 * terms + 1e-30).all())


@pytest.mark.parametrize("top_k", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_backward_selects_dropped_entries_as_jax(top_k, dtype):
    """A dropped entry's clamped slot is a valid slot of another token;
    with inf in that slot's gradient row, the plain formula's dx equals
    jax.vjp of the JAX package's ref.moe_dispatch (a where, so a
    dropped entry reads nothing): bit for bit at top_k <= 2, within
    (top_k - 1) roundings of the terms' magnitudes above that, the same
    infinities in the same places, and the dropped token's dx finite."""
    T, d, E = 24, 16, 12
    x, plan, _, C, _ = routing(top_k + 200, T, d, E, top_k, 0.5,
                               torch.float32)
    src, valid, flat_e, pos_c, keep, _ = plan
    slot = (flat_e * C + pos_c).to(torch.int32)
    dropped = int(torch.nonzero(~keep)[0])
    inf_slot = int(slot[dropped])
    assert bool(valid[inf_slot])            # another token's slot
    rng = np.random.default_rng(top_k)
    dbuf = rng.normal(size=(E * C, d)).astype(np.float32)
    dbuf[inf_slot] = np.inf
    dbuf[inf_slot, ::2] = -np.inf
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda a: jref.moe_dispatch(
        a, jnp.asarray(src.numpy()), jnp.asarray(valid.numpy())),
        jnp.asarray(x.numpy(), jdt))
    want = torch.as_tensor(np.array(
        vjp(jnp.asarray(dbuf, jdt))[0].astype(jnp.float32)))
    tdbuf = torch.as_tensor(dbuf).to(dtype)
    got = ref.moe_dispatch_bwd(tdbuf, slot, keep, T, top_k, dtype)
    assert got.dtype == dtype
    got = got.float()
    assert bool(torch.isfinite(got[dropped // top_k]).all())
    assert not bool(torch.isfinite(got).all())   # the slot's owner
    if top_k <= 2:
        assert torch.equal(got, want)
        return
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert torch.equal(got[~finite], want[~finite])
    exact = ref.moe_dispatch_bwd(tdbuf.double(), slot, keep, T, top_k)
    terms = ref.moe_dispatch_bwd(tdbuf.double().abs().nan_to_num(0, 0, 0),
                                 slot, keep, T, top_k)
    unit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    for a in (got, want):
        assert bool(((a.double() - exact).abs()[finite]
                     <= (top_k - 1) * unit * terms[finite]).all())


@pytest.mark.parametrize("top_k,cf", BWD_CASES)
def test_moe_functions_gradcheck(top_k, cf):
    """The dispatch and combine Functions of kernels/ops.py, in f64 on
    the CPU (the plain formulas), against finite differences."""
    T, d, E = 10, 5, 4
    x, plan, gates, C, m = routing(top_k + 100, T, d, E, top_k, cf,
                                   torch.float64)
    src, valid, flat_e, pos_c, keep, src_entry = plan
    slot = (flat_e * C + pos_c).to(torch.int32)
    ybuf = torch.randn(E * C, d, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(3))

    def dispatch(xx):
        return ops.moe_dispatch(xx, src, valid, slot=slot, keep=keep,
                                top_k=top_k)

    def combine(yy, gg):
        w = torch.where(keep, gg, 0.0)
        return ops.moe_combine(yy, slot, w, top_k, src_entry=src_entry,
                               valid=valid)
    assert torch.autograd.gradcheck(dispatch, (x.requires_grad_(True),))
    assert torch.autograd.gradcheck(
        combine, (ybuf.requires_grad_(True),
                  gates.reshape(-1).double().requires_grad_(True)))


# --------------------------------------------------------- optimizers --

def opt_trees(seed):
    """Parameters and 3 gradients: a factored (2-D and 3-D) and an
    unfactored leaf, under a tuple as the model's segments are."""
    rng = np.random.default_rng(seed)

    def tree_of(scale):
        return {"a": (rng.normal(size=(5,)) * scale).astype(np.float32),
                "segs": ({"w": (rng.normal(size=(4, 6)) * scale).astype(
                    np.float32)},
                         {"w": (rng.normal(size=(2, 3, 5)) * scale).astype(
                             np.float32)})}
    return tree_of(1.0), [tree_of(0.3) for _ in range(3)]


def torch_tree(t):
    return convert.model_params(t, "cpu")


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.1}),
                                     ("adafactor", {}),
                                     ("adafactor", {"weight_decay": 0.1})])
def test_optimizers_match_jax(name, kw):
    params, grads = opt_trees(5)
    jopt = joptim.build_optimizer(name, 0.05, **kw)
    opt = optim.build_optimizer(name, 0.05, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    p = torch_tree(params)
    s = opt.init(p)
    for i, g in enumerate(grads):
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                             jnp.int32(i))
        p, s = opt.update(torch_tree(g), s, p,
                          torch.tensor(i, dtype=torch.int32))
    for got, want in zip(tree.leaves(p), jax_leaves(jp)):
        assert max_rel(got, want) <= 1e-6
    jsl, sl = jax_leaves(js), tree.leaves(s)
    assert len(jsl) == len(sl)
    for got, want in zip(sl, jsl):
        assert max_rel(got, want) <= 1e-6


def whole_leaf_adafactor(params, grads, lr, weight_decay=0.0, eps=1e-30,
                         decay=0.8):
    """The reference's adafactor, one leaf at a time and each whole (its
    f32 temporaries the size of the leaf), over a list of gradient
    trees: (parameters, [per-leaf state dicts])."""
    ps = [p.clone() for p in tree.leaves(params)]
    states = [{"r": torch.zeros(p.shape[:-1]),
               "c": torch.zeros(p.shape[:-2] + p.shape[-1:])}
              if p.dim() >= 2 else {"v": torch.zeros(p.shape)} for p in ps]
    for i, g in enumerate(grads):
        beta = 1.0 - (torch.tensor(float(i)) + 1.0) ** (-decay)
        for p, gg, s in zip(ps, tree.leaves(g), states):
            gf = gg.float()
            g2 = gf * gf + eps
            if p.dim() >= 2:
                s["r"] = beta * s["r"] + (1 - beta) * torch.mean(g2, dim=-1)
                s["c"] = beta * s["c"] + (1 - beta) * torch.mean(g2, dim=-2)
                rc = s["r"] / torch.clamp_min(
                    torch.mean(s["r"], dim=-1, keepdim=True), eps)
                vhat = rc[..., None] * s["c"][..., None, :]
            else:
                s["v"] = beta * s["v"] + (1 - beta) * g2
                vhat = s["v"]
            u = gf * torch.rsqrt(torch.clamp_min(vhat, eps))
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp_min(rms, 1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
    return ps, states


def sliced_trees(seed):
    """Parameters and 3 gradients whose leaves span several slices of a
    small CHUNK: vectors, a matrix of 37 rows, stacked matrices."""
    rng = np.random.default_rng(seed)

    def tree_of(scale):
        return {"a": (rng.normal(size=(13,)) * scale).astype(np.float32),
                "b": (rng.normal(size=(37, 11)) * scale).astype(np.float32),
                "c": (rng.normal(size=(3, 5, 4, 6)) * scale).astype(
                    np.float32),
                "d": (rng.normal(size=(2, 9, 2)) * scale).astype(np.float32)}
    return tree_of(1.0), [tree_of(0.3) for _ in range(3)]


@pytest.mark.parametrize("chunk", [5, 7, 24, 100])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_sliced_adafactor_equals_the_whole_leaf_form(monkeypatch, chunk,
                                                     weight_decay):
    """adafactor over slices of ``CHUNK`` elements (rows of a matrix in
    blocks, matrices of a stack in groups, vectors flat; the statistics'
    and the RMS's sums over slices in order) against the whole-leaf
    formula: 3 updates, parameters and state within 1e-6 relative; and
    with CHUNK above every leaf, the same bits."""
    params, grads = sliced_trees(chunk)
    want, want_s = whole_leaf_adafactor(
        torch_tree(params), [torch_tree(g) for g in grads], 0.05,
        weight_decay)
    for size in (chunk, optim.optimizers.CHUNK):
        monkeypatch.setattr(optim.optimizers, "CHUNK", size)
        opt = optim.build_optimizer("adafactor", 0.05,
                                    weight_decay=weight_decay)
        p = torch_tree(params)
        s = opt.init(p)
        for i, g in enumerate(grads):
            p, s = opt.update(torch_tree(g), s, p,
                              torch.tensor(i, dtype=torch.int32))
        for got, w in zip(tree.leaves(p), want):
            if size == chunk:
                assert max_rel(got, w) <= 1e-6
            else:
                assert torch.equal(got, w)
        got_s = [s["f"][k] for k in sorted(s["f"])]
        for gs, ws in zip(got_s, want_s):
            assert sorted(gs) == sorted(ws)
            for k in gs:
                assert max_rel(gs[k], ws[k]) <= 1e-6


@pytest.mark.parametrize("chunk", [5, 24])
def test_sliced_clip_norm_equals_the_whole_leaf_norm(monkeypatch, chunk):
    """The clip's norm, each leaf's squares summed slice by slice in
    order, against one f32 sum a leaf: within 1e-6 relative; the scaled
    gradients likewise."""
    _, grads = sliced_trees(40 + chunk)
    g = grads[0]
    want = torch.sqrt(sum(torch.sum(torch.as_tensor(x) ** 2)
                          for x in tree.leaves(torch_tree(g))))
    monkeypatch.setattr(optim.optimizers, "CHUNK", chunk)
    got_g, got = optim.clip_by_global_norm(torch_tree(g), 0.5)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    for a, b in zip(tree.leaves(got_g), tree.leaves(torch_tree(g))):
        assert max_rel(a, b * (0.5 / want)) <= 1e-6


@pytest.mark.parametrize("steps", [[0, 1, 5, 9, 10, 11, 50, 99, 100, 150]])
def test_schedules_match_jax(steps):
    pairs = [(optim.constant(0.3), joptim.constant(0.3)),
             (optim.cosine_decay(1e-3, 100, 1e-5),
              joptim.cosine_decay(1e-3, 100, 1e-5)),
             (optim.warmup_cosine(2e-3, 10, 100),
              joptim.warmup_cosine(2e-3, 10, 100))]
    for fn, jfn in pairs:
        for s in steps:
            got = float(fn(torch.tensor(s, dtype=torch.int32)))
            want = float(jfn(jnp.int32(s)))
            assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (s, got,
                                                                 want)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, grads = opt_trees(6)
    jg, jn = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads[0]), max_norm)
    g, n = optim.clip_by_global_norm(torch_tree(grads[0]), max_norm)
    assert abs(float(n) - float(jn)) <= 1e-6 * float(jn)
    for got, want in zip(tree.leaves(g), jax_leaves(jg)):
        assert max_rel(got, want) <= 1e-6


def test_tree_helpers_match_jax():
    pr = Pair("granite-3-2b")
    assert tree.param_count(pr.p) == jtree.param_count(pr.jp)
    assert tree.tree_bytes(pr.p) == jtree.tree_bytes(pr.jp)
    assert abs(float(tree.tree_norm(pr.p)) - float(jtree.tree_norm(
        pr.jp))) <= 1e-6 * float(jtree.tree_norm(pr.jp))
    assert bool(tree.check_finite(pr.p))
    bad = tree.map_sorted(lambda a: a.clone(), pr.p)
    bad["embed"][0, 0] = float("nan")
    assert not bool(tree.check_finite(bad))


# -------------------------------------------------------- train steps --

@pytest.mark.parametrize("name,mb", [("mixtral-8x7b", 1), ("mixtral-8x7b", 2),
                                     ("granite-3-2b", 1), ("granite-3-2b", 2)])
def test_train_step_matches_jax(name, mb):
    """3 steps of the jitted JAX train_step and of the port's, from one
    JAX TrainState carried by convert.train_state: loss, grad norm and
    parameters after each step (Mixtral with capacity drops)."""
    pr = Pair(name, cf=0.75 if name.startswith("mixtral") else None,
              microbatch=mb)
    jopt = joptim.build_optimizer("adamw", 1e-3, eps=1e-4)
    opt = optim.build_optimizer("adamw", 1e-3, eps=1e-4)
    jstate = JaxTrainState(pr.jp, jopt.init(pr.jp), jnp.zeros((), jnp.int32))
    state = convert.train_state(as_np(jstate), "cpu")
    assert int(state.step) == 0 and state.params["embed"].dtype == \
        torch.float32
    jstep = jax.jit(jax_train_step(pr.jm, JaxCtx.local(), jopt))
    step = make_train_step(pr.m, None, opt)
    for i in range(3):
        toks, labels = pr.batch(B=4, S=32, seed=10 + i)
        jstate, jmet = jstep(jstate, jax_batch(toks, labels))
        state, met = step(state, torch_batch(toks, labels))
        assert int(state.step) == i + 1
        assert sorted(met) == sorted(jmet)
        for key in ("loss", "grad_norm"):
            assert abs(float(met[key]) - float(jmet[key])) <= 1e-5 * abs(
                float(jmet[key])), (i, key)
        for got, want in zip(tree.leaves(state.params),
                             jax_leaves(jstate.params)):
            err = np.max(np.abs(f32(got) - f32(want)))
            assert err <= 1e-5 * np.max(np.abs(f32(want))) + 1e-6, i
    for got, want in zip(tree.leaves(state.opt), jax_leaves(jstate.opt)):
        assert max_rel(got, want) <= 1e-4


def test_train_step_at_default_eps_matches_jax():
    """adamw at its default eps (1e-8), 3 steps of reduced granite-3-2b
    (f32, microbatch 1) from one state. The loss and grad norm within
    1e-5 relative after each step. A weight whose clipped gradient
    stayed well above eps at every step so far (|g| >= 1e3 eps, and
    >= 1e-2 of its leaf's largest |g|, so that the gradients' last-bit
    differences, some 1e-6 of that largest, stay below 1e-4 of |g|)
    within 1e-5 of its leaf's largest magnitude + 1e-6, as at eps 1e-4.
    Every other weight within 2.01 lr a step taken of JAX's (one adam
    step |m_hat / (sqrt(v_hat) + eps)| is at most 1.001 at b1 = 0.9,
    b2 = 0.95 over 3 steps, so two runs differ by at most twice that);
    those are counted, and are fewer than half."""
    pr = Pair("granite-3-2b")
    lr, eps = 1e-3, 1e-8
    jopt = joptim.build_optimizer("adamw", lr)
    opt = optim.build_optimizer("adamw", lr)
    jstate = JaxTrainState(pr.jp, jopt.init(pr.jp), jnp.zeros((), jnp.int32))
    state = convert.train_state(as_np(jstate), "cpu")
    jstep = jax.jit(jax_train_step(pr.jm, JaxCtx.local(), jopt))
    jgrad = jax.jit(jax.grad(
        lambda p, b: pr.jm.loss(p, b, JaxCtx.local())[0]))
    step = make_train_step(pr.m, None, opt)
    near = [np.zeros(a.shape, bool) for a in jax_leaves(jstate.params)]
    for i in range(3):
        toks, labels = pr.batch(B=4, S=32, seed=10 + i)
        grads = jgrad(jstate.params, jax_batch(toks, labels))
        jstate, jmet = jstep(jstate, jax_batch(toks, labels))
        state, met = step(state, torch_batch(toks, labels))
        for key in ("loss", "grad_norm"):
            assert abs(float(met[key]) - float(jmet[key])) <= 1e-5 * abs(
                float(jmet[key])), (i, key)
        scale = min(1.0, 1.0 / max(float(jmet["grad_norm"]), 1e-9))
        for n, g in zip(near, jax_leaves(grads)):
            ga = np.abs(np.asarray(g, np.float32)) * scale
            n |= ga < max(1e3 * eps, 1e-2 * float(ga.max()))
        for n, got, want in zip(near, tree.leaves(state.params),
                                jax_leaves(jstate.params)):
            diff = np.abs(f32(got) - f32(want))
            assert np.all(diff[~n] <= 1e-5 * np.max(np.abs(f32(want)))
                          + 1e-6), i
            assert np.all(diff[n] <= 2.01 * lr * (i + 1)), i
    counted = sum(int(n.sum()) for n in near)
    total = sum(n.size for n in near)
    assert 0 < counted < 0.5 * total, (counted, total)


@pytest.mark.parametrize("name,kw", [("sgd", {"momentum": 0.9}),
                                     ("adafactor", {})])
def test_train_state_carries_other_optimizers(name, kw):
    """convert.train_state carries sgd's and adafactor's trees (one JAX
    update taken, so the moments are not zero), and the next update
    agrees."""
    params, grads = opt_trees(8)
    jopt = joptim.build_optimizer(name, 0.05, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[0]),
                         jopt.init(jp), jp, jnp.int32(0))
    state = convert.train_state(as_np(JaxTrainState(jp, js, jnp.int32(1))),
                                "cpu")
    assert int(state.step) == 1
    jp, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[1]), js,
                        jp, jnp.int32(1))
    p, _ = optim.build_optimizer(name, 0.05, **kw).update(
        torch_tree(grads[1]), state.opt, state.params, state.step)
    for got, want in zip(tree.leaves(p), jax_leaves(jp)):
        assert max_rel(got, want) <= 1e-6


def test_train_loop_lowers_the_loss():
    """examples/train_lm.py's run at a shorter length: reduced
    granite-3-2b on the synthetic stream, adamw at lr 3e-3; the last
    logged loss below the first, then generate."""
    cfg = get_config("granite-3-2b", reduced=True)
    model = build_model(cfg)
    state, history = train_loop(
        model, synthetic_batches(0, cfg.vocab_size, B=8, S=65, steps=40),
        steps=40, lr=3e-3, log_every=10, device="cpu")
    assert [s for s, _ in history] == [0, 10, 20, 30, 39]
    assert history[-1][1] < history[0][1]
    prompt = {"tokens": torch.arange(16, dtype=torch.int32)[None].repeat(
        4, 1)}
    out = generate(model, state.params, prompt, steps=8)
    assert tuple(out.shape) == (4, 8)


def test_synthetic_stream_follows_its_rule():
    batch = next(synthetic_batches(2, 97, B=3, S=20, steps=1))
    toks, labels = batch["tokens"], batch["labels"]
    assert toks.shape == labels.shape == (3, 19)
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    follows = labels == (3 * toks.astype(np.int64) + 7) % 97
    assert follows.mean() > 0.9
