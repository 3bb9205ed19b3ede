"""Training under a mesh (``launch/train.py`` with a ``DistCtx`` whose
mesh cuts the MoE layers' experts; the differentiable collectives of
``utils/mesh.py``; ``launch/sharding.opt_spec`` / ``param_shards``;
``convert.train_state(..., cfg=, ctx=)``) against the JAX package's
``make_train_step`` jitted with its sharded layouts, in gloo worlds of 2
and 4 ranks on the CPU.

Each world is one ``torch.multiprocessing.spawn`` whose ranks run every
case of that world (``_torch_ep_train_ranks``); the JAX side runs
meanwhile in one process of its own on 8 forced host devices
(``_torch_ep_train_jax``): every train case jitted with
``param_specs`` / ``opt_specs`` / ``batch_specs`` as
``launch/dryrun.py`` lays them out. The restore cases wait for its
output. The bars, in f32:

- after each of 3 steps the loss and the grad norm within 1e-5 relative
  of JAX's; after the last every parameter, its parts put together,
  within 1e-5 of the largest magnitude of JAX's leaf; each MoE layer on
  the same path as JAX's; every replicated leaf the same bits on every
  rank, and each part the same bits on every rank that holds it; padded
  experts zero;
- Mixtral with adamw at eps 1e-4 (as tests/test_torch_train.py: at 1e-8
  a gradient's last-bit difference near 0 moves a weight by up to lr),
  DeepSeek-V3 with adafactor and its MTP head;
- at a dropless capacity factor the mesh's step equals the port's
  single-device step within the same bars (at 1.25 capacity is counted
  per data shard, so the two are different functions). The load-balance
  loss is taken on each shard's tokens and averaged over the shards (the
  reference's pmean), which is another function of the routing than the
  whole batch's wherever the shards see different tokens (dp > 1, or
  the alltoall path's tokens cut over tp): the dropless cases run with
  ``router_aux_weight`` 0, against JAX too;
- each differentiable collective's output and input gradient equal to
  what ``jax.vjp`` of the same ``shard_map`` op gives (integer-valued
  inputs: the sums are exact).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import _torch_ep_ranks as R  # noqa: E402
import _torch_ep_train_ranks as TR  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch.sharding import opt_specs, param_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.launch.serve import init_params  # noqa: E402
from repro_torch.launch.sharding import held_spec, opt_spec  # noqa: E402
from repro_torch.models.common import DistCtx  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.tree import leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
GROUP_AXES = (("model",), ("data",), ("data", "model"), ("model", "data"))
ADAMW = ("adamw", {"lr": 1e-3, "eps": 1e-4})
ADAFACTOR = ("adafactor", {"lr": 1e-3})
# (config, MoE overrides, optimizer): reduced Mixtral as configured
# (impl="dense": expert tensor parallelism), reduced DeepSeek-V3 with
# its full config's alltoall over ep="tp" or "2d" (ds-tp6: 6 experts,
# padded to 8 at 4 shards).
MODELS = {"mixtral": ("mixtral-8x7b", {}, ADAMW),
          "ds-tp": ("deepseek-v3-671b", {"impl": "alltoall", "ep": "tp"},
                    ADAFACTOR),
          "ds-2d": ("deepseek-v3-671b", {"impl": "alltoall", "ep": "2d"},
                    ADAFACTOR),
          "ds-tp6": ("deepseek-v3-671b", {"impl": "alltoall", "ep": "tp",
                                          "n_experts": 6}, ADAFACTOR)}
STEPS, SEED = 3, 0
DROPLESS = None
# (world, mesh, model, capacity factor (DROPLESS: E / top_k),
# microbatch, B, S)
TRAIN = [(2, (1, 2), "mixtral", 1.25, 1, 4, 16),
         (2, (2, 1), "mixtral", DROPLESS, 2, 4, 16),
         (2, (1, 2), "ds-2d", 1.25, 1, 4, 16),
         # B = 3 does not split over dp = 2: the local fallback, the
         # experts gathered from their parts over (data, model). (At
         # (2, 2) such a batch meets a fault of the JAX side: its embed
         # gradient is off, ROADMAP.md section 3.)
         (2, (2, 1), "ds-2d", 1.25, 1, 3, 16),
         (4, (2, 2), "mixtral", 1.25, 2, 4, 16),
         (4, (1, 4), "mixtral", DROPLESS, 1, 4, 16),
         (4, (2, 2), "ds-2d", 1.25, 2, 4, 16),
         (4, (1, 4), "ds-tp6", DROPLESS, 1, 4, 16),
         # 15 tokens a data shard do not split over tp = 2: the alltoall
         # layer falls back to expert tensor parallelism, its parts
         # gathered over model (and their gradient reduce-scattered).
         (4, (2, 2), "ds-tp", 1.25, 1, 2, 15)]
# The gradient at the first batch, against JAX's sharded jax.grad.
GRADS = ("mixtral-1x2-cf1.25-mb1-4x16", "ds-2d-1x2-cf1.25-mb1-4x16")
# JAX's state after step 2 restored under the mesh, then step 3.
RESTORE = ("mixtral-2x2-cf1.25-mb2-4x16", "ds-2d-2x2-cf1.25-mb2-4x16")
EXPECTED_PATHS = {"mixtral-1x2-cf1.25-mb1-4x16": ["etp"],
                  "ds-2d-2x1-cf1.25-mb1-3x16": ["local"],
                  "ds-2d-1x2-cf1.25-mb1-4x16": ["alltoall"],
                  "ds-2d-2x2-cf1.25-mb2-4x16": ["alltoall"],
                  "ds-tp6-1x4-cfNone-mb1-4x16": ["alltoall"],
                  "ds-tp-2x2-cf1.25-mb1-2x15": ["etp"]}


def _key(mesh, model, cf, mb, b, s):
    return f"{model}-{mesh[0]}x{mesh[1]}-cf{cf}-mb{mb}-{b}x{s}"


TRAIN_CASES = [(c[0], _key(*c[1:]), c) for c in TRAIN]


def _cfgs(model, cf=DROPLESS, mb=1):
    """(JAX config, port config) of ``model`` in f32 at capacity factor
    ``cf`` (DROPLESS: E / top_k, without the load-balance loss) and
    microbatch ``mb``."""
    name, over, _ = MODELS[model]
    out = []
    for cfg in (jax_config(name, reduced=True), get_config(name,
                                                           reduced=True)):
        m = dataclasses.replace(cfg.moe, **over)
        if cf is DROPLESS:
            m = dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k,
                                    router_aux_weight=0.0)
        else:
            m = dataclasses.replace(m, capacity_factor=cf)
        out.append(cfg.replace(dtype="float32", microbatch=mb, moe=m))
    return out


def _batches(key, vocab, b, s):
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
        labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
        labels[:, ::5] = -1
        out.append((toks, labels))
    return out


def _specs():
    """(the port's train specs, the JAX side's) by case key."""
    draws, port, jx = {}, {}, {}
    for _, key, (_, mesh, model, cf, mb, b, s) in TRAIN_CASES:
        jcfg, cfg = _cfgs(model, cf, mb)
        if model not in draws:
            # The port's whole draw, handed to the JAX package leaf for
            # leaf; each rank draws its parts from the same seed.
            draws[model] = [a.numpy() for a in leaves(init_params(
                build_model(cfg), seed=SEED, device="cpu"))]
        batches = _batches(key, cfg.vocab_size, b, s)
        common = {"name": cfg.name, "moe": dataclasses.asdict(cfg.moe),
                  "microbatch": mb, "mesh": mesh, "batches": batches,
                  "optimizer": MODELS[model][2]}
        port[key] = dict(common, seed=SEED, grads=key in GRADS,
                         single=cf is DROPLESS)
        jx[key] = dict(common, moe=dataclasses.asdict(jcfg.moe),
                       leaves=draws[model], grads=key in GRADS,
                       keep=(2, STEPS) if key in RESTORE else (STEPS,))
    return port, jx


def _collective_specs(mesh):
    """Integer-valued inputs and cotangents of every op, for each group
    of ``mesh`` (n shards): rows of 3, ``x`` 2n a shard (all_to_all
    sends 2 to each), ``rep`` 2n."""
    out = {}
    for axes in GROUP_AXES:
        n = int(np.prod([dict(zip(R.NAMES, mesh))[a] for a in axes]))
        rng = np.random.default_rng(zlib.crc32(repr((mesh, axes)).encode()))

        def draw(rows):
            return rng.integers(-8, 9, size=(rows, 3)).astype(np.float32)
        out[axes] = {"x": draw(2 * n * n), "rep": draw(2 * n), "n": n,
                     "ct": {"psum": draw(2 * n),
                            "all_gather": draw(2 * n * n),
                            "all_gather_rs": draw(2 * n * n * n),
                            "all_to_all": draw(2 * n * n),
                            "psum_grad": draw(2 * n * n),
                            "shard_rows": draw(2 * n)}}
    return out


@pytest.fixture(scope="module")
def runs():
    """Both worlds' spawns and the JAX process, side by side."""
    port, jx = _specs()
    colls = {m: _collective_specs(m) for ms in MESHES.values() for m in ms}
    jax_colls = {m: {axes: dict(spec, mesh=m) for axes, spec in by.items()}
                 for m, by in colls.items()}
    dense = {"name": "granite-3-2b", "moe": None, "microbatch": 2,
             "mesh": (2, 2), "seed": SEED, "optimizer": ADAMW,
             "batches": _batches("granite", get_config(
                 "granite-3-2b", reduced=True).vocab_size, 4, 16)}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = (os.path.join(tmp, "jax_in.pkl"),
                    os.path.join(tmp, "jax_out.pkl"))
        with open(src, "wb") as f:
            pickle.dump({"train": jx, "collectives": jax_colls}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(HERE, "..", "src"), os.environ.get(
                "PYTHONPATH", "")]))
        child = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_ep_train_jax.py"),
             src, dst], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        ranks = {}
        try:
            for world, meshes in MESHES.items():
                cases = {
                    "collectives": {m: {"mesh": m, "groups": colls[m]}
                                    for m in meshes},
                    "train": {k: port[k] for w, k, _ in TRAIN_CASES
                              if w == world},
                    "dense": {"granite": dense} if world == 4 else {},
                    "restore": {k: dict(port[k], jax_out=dst, of=k,
                                        after=2,
                                        batches=port[k]["batches"][2:])
                                for w, k, _ in TRAIN_CASES
                                if w == world and k in RESTORE}}
                wdir = os.path.join(tmp, f"world{world}")
                os.mkdir(wdir)
                ranks[world] = R.spawn(world, wdir, cases, TR.CASES)
        finally:
            _, err = child.communicate(timeout=900)
        assert child.returncode == 0, err[-4000:]
        with open(dst, "rb") as f:
            jax_out = pickle.load(f)
    return SimpleNamespace(ranks=ranks, jax=jax_out, colls=colls)


def _world(key):
    return next(w for w, k, _ in TRAIN_CASES if k == key)


def _rel(got, want):
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _whole(outs, i, want_shape):
    """Leaf ``i`` put together from every rank's part (rows past the
    whole leaf's extent dropped: padded experts, which must be zero),
    after checking that ranks holding one part hold the same bits."""
    part = outs[0]["parts"][i]
    if part is None:
        for r, o in enumerate(outs[1:], 1):
            assert np.array_equal(o["params"][i], outs[0]["params"][i]), (
                f"replicated leaf {i} differs on rank {r}")
        return outs[0]["params"][i]
    axis = part[0]
    held = {}
    for o in outs:
        _, lo, hi = o["parts"][i]
        if lo in held:
            assert np.array_equal(held[lo], o["params"][i]), (
                f"part {lo}:{hi} of leaf {i} differs across its ranks")
        held[lo] = o["params"][i]
    cat = np.concatenate([held[lo] for lo in sorted(held)], axis=axis)
    ext = want_shape[axis]
    pad = np.take(cat, range(ext, cat.shape[axis]), axis=axis)
    assert not pad.any(), f"leaf {i}: padded experts are not zero"
    return np.take(cat, range(ext), axis=axis)


def _check_params(outs, want_leaves, what, bar=1e-5):
    assert len(outs[0]["params"]) == len(want_leaves)
    for i, want in enumerate(want_leaves):
        got = _whole(outs, i, want.shape)
        assert got.shape == want.shape, (what, i, got.shape, want.shape)
        err = float(np.max(np.abs(got - want)))
        assert err <= bar * float(np.max(np.abs(want))), (what, i, err)


def _check_metrics(got, want, what):
    for name in ("loss", "grad_norm"):
        for step, (a, b) in enumerate(zip(got[name], want[name])):
            assert abs(a - b) <= 1e-5 * abs(b), (what, name, step, a, b)


# ------------------------------------------------------ the collectives --

COLL_CASES = [(w, m, axes) for w, ms in MESHES.items() for m in ms
              for axes in GROUP_AXES]


@pytest.mark.parametrize("world,mesh,axes", COLL_CASES,
                         ids=[f"{m[0]}x{m[1]}-{'-'.join(a)}"
                              for _, m, a in COLL_CASES])
def test_collective_backward_matches_jax_vjp(runs, world, mesh, axes):
    """psum, all_gather (rows and reduce-scatter backward), all_to_all,
    psum_grad and shard_rows: this rank's output and gradient are JAX's
    global output and vjp cut to this rank (a replicated one whole)."""
    want = runs.jax["collectives"][mesh][axes]
    n = runs.colls[mesh][axes]["n"]
    # Rows a shard of the output, and of the gradient (None: whole).
    r = 2 * n
    layout = {"psum": (None, r), "all_gather": (None, r),
              "all_gather_rs": (r * n, r), "all_to_all": (r, r),
              "psum_grad": (r, None), "shard_rows": (2, None)}
    for rank, out in enumerate(runs.ranks[world]):
        got = out["collectives"][mesh][axes]
        i = got["index"]
        for op, (y_rows, g_rows) in layout.items():
            y, g = got["ops"][op]
            wy, wg = want[op]
            if y_rows is not None:
                wy = wy[i * y_rows:(i + 1) * y_rows]
            if g_rows is not None:
                wg = wg[i * g_rows:(i + 1) * g_rows]
            assert np.array_equal(y, wy), (rank, op, "output")
            assert np.array_equal(g, wg), (rank, op, "gradient")


# --------------------------------------------------------- the gradient --

@pytest.mark.parametrize("key", GRADS)
def test_mesh_train_step_reaches_router_and_experts(runs, key):
    """Under a gloo mesh of 2 ranks (the etp and the alltoall path) the
    router's and every expert part's gradient are nonzero and, put
    together, JAX's sharded gradient (every leaf within 1e-5 of its
    largest magnitude)."""
    outs = [r["train"][key] for r in runs.ranks[_world(key)]]
    want = leaves(runs.jax["train"][key]["grads"])
    flat = [{"params": o["grads"], "parts": o["parts"]} for o in outs]
    _check_params(flat, want, key)
    names = [path for path in _leaf_paths(runs.jax["train"][key]["grads"])]
    moe_leaves = [i for i, p in enumerate(names) if "moe" in p and p[-1] in (
        "router", "w1", "w3", "w2")]
    assert len(moe_leaves) >= 4
    for i in moe_leaves:
        for o in outs:
            assert np.any(o["grads"][i] != 0), (key, names[i])


def _leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for t in tree for p in _leaf_paths(t, path)]
    return [path]


# ------------------------------------------------------ the train steps --

@pytest.mark.parametrize("world,key", [(w, k) for w, k, _ in TRAIN_CASES])
def test_train_step_under_mesh_matches_jax(runs, world, key):
    outs = [r["train"][key] for r in runs.ranks[world]]
    want = runs.jax["train"][key]
    for o in outs[1:]:
        assert o["loss"] == outs[0]["loss"], key
        assert o["grad_norm"] == outs[0]["grad_norm"], key
    _check_metrics(outs[0], want, key)
    assert all(o["paths"] == want["paths"] for o in outs), (
        key, outs[0]["paths"], want["paths"])
    if key in EXPECTED_PATHS:
        assert want["paths"] == EXPECTED_PATHS[key], (key, want["paths"])
    _check_params(outs, leaves(want["states"][STEPS][0]), key)


@pytest.mark.parametrize("world,key", [(w, k) for w, k, c in TRAIN_CASES
                                       if c[3] is DROPLESS])
def test_dropless_mesh_step_equals_single_device(runs, world, key):
    """At a dropless capacity factor the sharded step is the function of
    the single-device one: the port's two within the JAX bars."""
    outs = [r["train"][key] for r in runs.ranks[world]]
    single = outs[0]["single"]
    _check_metrics(outs[0], single, key)
    _check_params(outs, single["params"], key)


def test_dense_model_under_mesh_is_the_single_device_step(runs):
    """Reduced granite (no expert leaf) under (2, 2), where its dense
    layers are tensor-parallel and its batch cut over data
    (``launch/sharding.py``): every rank's loss and grad norm the same
    bits, and the single-device step's within 1e-5; every parameter,
    its parts put together, within 1e-5 of the single-device step's
    largest magnitude (replicated leaves and each part the same bits on
    every rank that holds it)."""
    outs = [out["dense"]["granite"] for out in runs.ranks[4]]
    for r, got in enumerate(outs):
        assert got["mesh"]["loss"] == outs[0]["mesh"]["loss"], r
        assert got["mesh"]["grad_norm"] == outs[0]["mesh"]["grad_norm"], r
    _check_metrics(outs[0]["mesh"], outs[0]["single"], "granite")
    _check_params([o["mesh"] for o in outs], outs[0]["single"]["params"],
                  "granite")


@pytest.mark.parametrize("key", RESTORE)
def test_restored_sharded_state_matches_jax(runs, key):
    """JAX's sharded-run state after step 2, cut by convert.train_state(
    ..., cfg=, ctx=), then the port's step 3: JAX's step 3."""
    outs = [r["restore"][key] for r in runs.ranks[_world(key)]]
    want = runs.jax["train"][key]
    assert all(o["step"] == STEPS for o in outs)
    got = {"loss": outs[0]["loss"], "grad_norm": outs[0]["grad_norm"]}
    _check_metrics(got, {"loss": want["loss"][2:],
                         "grad_norm": want["grad_norm"][2:]}, key)
    _check_params(outs, leaves(want["states"][STEPS][0]), key)


def test_one_rank_mesh_train_step_is_the_local_step():
    """A (1, 1) mesh in a gloo world of one: every path is the local
    path, and 2 steps of reduced Mixtral and DeepSeek-V3 (2d, MTP,
    adafactor) give the single-device step's bits."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        ctx = make_ctx(make_mesh((1, 1), R.NAMES, backend="gloo"))
        for model_name in ("mixtral", "ds-2d"):
            _, cfg = _cfgs(model_name, 1.25)
            model = build_model(cfg)
            name, kw = MODELS[model_name][2]
            batches = _batches(model_name, cfg.vocab_size, 2, 16)[:2]
            runs = []
            for c in (ctx, None):
                opt = build_optimizer(name, **kw)
                state = init_state(model, torch.Generator().manual_seed(1),
                                   opt, ctx=c)
                step = make_train_step(model, c, opt)
                mets = []
                for toks, labels in batches:
                    state, met = step(state, {
                        "tokens": torch.as_tensor(toks),
                        "labels": torch.as_tensor(labels)})
                    mets.append((float(met["loss"]),
                                 float(met["grad_norm"])))
                runs.append((mets, leaves(state.params), leaves(state.opt)))
            (m1, p1, o1), (m0, p0, o0) = runs
            assert m1 == m0, model_name
            assert all(torch.equal(a, b) for a, b in zip(p1 + o1, p0 + o0))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ the state layout --

def _stub(shape, names):
    sizes = dict(zip(names, shape))
    return SimpleNamespace(
        shape=sizes, axis_names=names,
        index=lambda axes: 0,
        size=lambda axes: int(np.prod([sizes[a] for a in axes])))


RULE_MESHES = [((2, 4), ("data", "model")), ((1, 4), ("data", "model")),
               ((4, 2), ("data", "model")), ((2, 2, 4), ("pod", "data",
                                                         "model")),
               ((8, 1), ("data", "model"))]
IMPLS = (("dense", "tp"), ("alltoall", "tp"), ("alltoall", "2d"))


@pytest.mark.parametrize("shape,names", RULE_MESHES)
@pytest.mark.parametrize("impl,ep", IMPLS)
def test_opt_spec_matches_opt_specs(shape, names, impl, ep):
    """The port's cut of each expert leaf's optimizer state (adamw's m
    and v, adafactor's r and c) against the JAX package's ``opt_specs``
    over its ``param_specs`` (without FSDP), for a layer-stacked leaf."""
    stub = _stub(shape, names)
    dp = tuple(a for a in names if a != "model")
    jcfg = jax_config("deepseek-v3-671b", reduced=True).replace(fsdp=False)
    m = dataclasses.replace(jcfg.moe, n_experts=16, d_expert=64, impl=impl,
                            ep=ep)
    jcfg = jcfg.replace(moe=m)
    cfg = SimpleNamespace(moe=MoEConfig(**dataclasses.asdict(m)))
    L, d = 3, jcfg.d_model
    shapes = {"w1": (L, 16, d, 64), "w3": (L, 16, d, 64),
              "w2": (L, 16, 64, d)}
    params = {"segments": ({"moe": {
        k: jax.ShapeDtypeStruct(v, np.float32)
        for k, v in shapes.items()}},)}
    pspecs = param_specs(params, jcfg, stub, dp)
    ctx = DistCtx(mesh=stub, dp=dp)
    for opt_name, keys in (("adamw", ("m", "v")), ("adafactor", ("r", "c"))):
        state = jax.eval_shape(joptim.build_optimizer(opt_name, 1e-3).init,
                               params)
        specs = opt_specs(state, pspecs)
        for key in keys:
            for name in shapes:
                if opt_name == "adamw":
                    spec = specs[key]["segments"][0]["moe"][name]
                else:
                    spec = specs["f"]["segments"][0]["moe"][name][key]
                want = tuple(None if a is None else (a,) if isinstance(
                    a, str) else tuple(a) for a in spec)
                got = opt_spec(held_spec(cfg, ctx, (
                    "segments", "0", "moe", name), shapes[name]), key)
                assert got == want, (opt_name, key, name, got, want)


def test_state_parts_tile_jax_state():
    """convert.train_state's cut of an adafactor state: each rank's r and
    c of every expert leaf, put together over a (2, 2) mesh, are the
    whole state's (the state cut as opt_spec lays it out)."""
    from repro_torch.launch.sharding import shard_params, state_parts
    from repro_torch.models.common import take_parts
    for impl, ep in IMPLS:
        m = MoEConfig(n_experts=4, top_k=2, d_expert=8, impl=impl, ep=ep)
        cfg = SimpleNamespace(moe=m)
        rng = np.random.default_rng(0)
        state = {"f": {"moe": {
            "w1": {"r": rng.normal(size=(4, 6)), "c": rng.normal(
                size=(4, 8))},
            "w2": {"r": rng.normal(size=(4, 8)), "c": rng.normal(
                size=(4, 6))}}}}
        for data in range(2):
            for model in range(2):
                stub = _stub((2, 2), R.NAMES)
                stub.index = (lambda c: lambda axes: int(np.ravel_multi_index(
                    [c[a] for a in axes], [2] * len(axes))))(
                        {"data": data, "model": model})
                ctx = DistCtx(mesh=stub)
                shapes = {("moe", "w1"): (4, 6, 8), ("moe", "w2"): (4, 8, 6)}
                cut = shard_params(state, cfg, ctx, shapes=shapes)["f"]["moe"]
                for name in ("w1", "w2"):
                    path = ("moe", name)
                    for key in ("r", "c"):
                        sps = state_parts(cfg, ctx, path, shapes[path], key)
                        whole = state["f"]["moe"][name][key]
                        want = take_parts(sps, whole)
                        assert np.array_equal(cut[name][key], want)
                        spec = opt_spec(held_spec(cfg, ctx, path,
                                                  shapes[path]), key)
                        cut_dims = [i for i, a in enumerate(spec) if a]
                        assert [p.axis % 2 for p in sps] == cut_dims


def test_forward_only_collectives_refuse_a_gradient():
    """all_gather_many, all_gather(..., active=), pmax and pmin carry no
    gradient: a tensor that requires one is refused by name."""
    import torch.distributed as dist
    from repro_torch.utils.mesh import MeshError, make_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        g = make_mesh((1, 1), R.NAMES, backend="gloo").group(R.NAMES)
        x = torch.ones(2, 3, requires_grad=True)
        for name, fn in (("all_gather_many", lambda: g.all_gather_many([x])),
                         ("active=", lambda: g.all_gather(x, active=1)),
                         ("pmax", lambda: g.pmax(x)),
                         ("pmin", lambda: g.pmin(x))):
            with pytest.raises(MeshError, match=name):
                fn()
            with torch.no_grad():
                fn()
        with pytest.raises(MeshError, match="grad="):
            g.all_gather(x, grad="sum")
    finally:
        dist.destroy_process_group()
