"""The port's expert-parallel MoE paths (``models/moe.py`` under a mesh,
``utils/mesh.ShardGroup.all_to_all``, ``launch/sharding.py``) against the
JAX package's, in gloo worlds of 2 and 4 ranks on the CPU.

Each world is one ``torch.multiprocessing.spawn`` whose ranks run every
case of that world (``_torch_ep_ranks``); the JAX package's sharded
``apply_moe`` and prefill run meanwhile in one process of their own on 8
forced host devices (``_torch_ep_jax``). The bar: the port's sharded
``apply_moe`` within 1e-5 of the largest entry of JAX's output in f32
(tokens dropping at capacity factor 1.25, and dropless), its aux loss
within 1e-6, the same path chosen (fallbacks included), the same bits on
every rank; a reduced model's ``generate`` under the mesh gives the
single-device port's tokens at a dropless factor, and its prefill
logits at the config's factor are within 1e-5 of JAX's sharded
prefill's.
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
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch.sharding import param_specs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import DistCtx as JaxCtx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.launch.serve import generate, init_params  # noqa: E402
from repro_torch.launch.sharding import expert_spec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import DistCtx, tree_map  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.tree import leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
A2A_AXES = (("model",), ("data",), ("data", "model"), ("model", "data"))
IMPLS = (("dense", "tp"), ("alltoall", "tp"), ("alltoall", "2d"))
# One layer: B x S tokens of d, E experts top-2 of d_expert (a multiple
# of 4, so that the tensor-parallel path runs at every tp here).
B, S, D, DFF, TOP_K = 4, 8, 16, 24, 2
STEPS = 4


def _layer_key(mesh, impl, ep, E, cf, b=B, s=S):
    return f"{mesh[0]}x{mesh[1]}-{impl}-{ep}-E{E}-cf{cf}-{b}x{s}"


def _layer_cases():
    """(world, key, spec fields): every path on every mesh, E=8 and E=6
    (E_pad > E at 4 shards), at 1.25 (tokens drop) and dropless (E /
    top_k: C = T); then the fallbacks: B % dp != 0 on (2, 2), and
    T_shard < tp on (1, 4)."""
    out = []
    for world, meshes in MESHES.items():
        for mesh in meshes:
            for impl, ep in IMPLS:
                for E in (8, 6):
                    for cf in (1.25, E / TOP_K):
                        out.append((world, mesh, impl, ep, E, cf, B, S))
    for impl, ep in IMPLS:
        out.append((4, (2, 2), impl, ep, 8, 1.25, 3, S))
        out.append((4, (1, 4), impl, ep, 8, 1.25, 1, 2))
    return [(c[0], _layer_key(*c[1:]), c) for c in out]


LAYER_CASES = _layer_cases()
# (config, MoE overrides): reduced Mixtral as configured (impl="dense":
# expert tensor parallelism), reduced DeepSeek-V3 with its full config's
# alltoall / 2d expert parallelism.
MODELS = {"mixtral": ("mixtral-8x7b", {}),
          "deepseek": ("deepseek-v3-671b", {"impl": "alltoall",
                                            "ep": "2d"})}
MODEL_MESHES = {2: (1, 2), 4: (2, 2)}
MODEL_CASES = [(w, f"{name}-{w}") for name in MODELS for w in MODEL_MESHES]


def _layer_spec(case):
    _, mesh, impl, ep, E, cf, b, s = case
    rng = np.random.default_rng(zlib.crc32(_layer_key(*case[1:]).encode()))
    f32 = np.float32
    params = {"router": (rng.normal(size=(D, E)) * .5).astype(f32),
              "w1": (rng.normal(size=(E, D, DFF)) * .2).astype(f32),
              "w3": (rng.normal(size=(E, D, DFF)) * .2).astype(f32),
              "w2": (rng.normal(size=(E, DFF, D)) * .2).astype(f32)}
    return {"mesh": mesh, "x": rng.normal(size=(b, s, D)).astype(f32),
            "params": params,
            "moe": dict(n_experts=E, top_k=TOP_K, d_expert=DFF,
                        capacity_factor=cf, impl=impl, ep=ep)}


def _model_cfgs(name):
    cname, over = MODELS[name]
    jcfg = jax_config(cname, reduced=True).replace(dtype="float32")
    cfg = get_config(cname, reduced=True).replace(dtype="float32")
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, **over)),
            cfg.replace(moe=dataclasses.replace(cfg.moe, **over)))


@pytest.fixture(scope="module")
def runs():
    """Both worlds' spawns and the JAX process, run side by side; then
    the single-device port's dropless generate of each model."""
    layers = {k: _layer_spec(c) for _, k, c in LAYER_CASES}
    models, jax_models = {}, {}
    for name in MODELS:
        jcfg, cfg = _model_cfgs(name)
        # The port's draw, handed to the JAX package leaf for leaf.
        np_params = tree_map(lambda a: a.numpy(), init_params(
            build_model(cfg), seed=0, device="cpu"))
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
        for w, mesh in MODEL_MESHES.items():
            models[f"{name}-{w}"] = {
                "name": cfg.name, "mesh": mesh, "params": np_params,
                "moe": dataclasses.asdict(cfg.moe), "tokens": tokens,
                "dropless": cfg.moe.n_experts / cfg.moe.top_k,
                "steps": STEPS}
            jax_models[f"{name}-{w}"] = {
                "name": cfg.name, "mesh": mesh, "tokens": tokens,
                "moe": dataclasses.asdict(jcfg.moe),
                "leaves": leaves(np_params)}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "jax_in.pkl"), os.path.join(
            tmp, "jax_out.pkl")
        with open(src, "wb") as f:
            pickle.dump({"layers": layers, "models": jax_models}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(HERE, "..", "src"), os.environ.get(
                "PYTHONPATH", "")]))
        child = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_ep_jax.py"), src,
             dst], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        ranks = {}
        for world, meshes in MESHES.items():
            cases = {
                "a2a": {m: {"mesh": m, "axes": A2A_AXES} for m in meshes},
                "layers": {k: layers[k] for w, k, _ in LAYER_CASES
                           if w == world},
                "models": {k: models[k] for w, k in MODEL_CASES
                           if w == world}}
            wdir = os.path.join(tmp, f"world{world}")
            os.mkdir(wdir)
            ranks[world] = R.spawn(world, wdir, cases)
        _, err = child.communicate(timeout=600)
        assert child.returncode == 0, err[-4000:]
        with open(dst, "rb") as f:
            jax_out = pickle.load(f)
    single = {}
    for name in MODELS:
        _, cfg = _model_cfgs(name)
        spec = models[f"{name}-2"]
        params = convert.model_params(spec["params"], "cpu")
        dropless = build_model(cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=spec["dropless"])))
        stats = {}
        toks = generate(dropless, params, {"tokens": spec["tokens"]},
                        steps=STEPS, stats=stats)
        single[name] = (toks.numpy(), np.stack(
            [lg.numpy() for lg in stats["logits"]]))
    return SimpleNamespace(ranks=ranks, jax=jax_out, single=single,
                           layers=layers)


def _same_on_every_rank(outs, what):
    for r, o in enumerate(outs[1:], 1):
        assert np.array_equal(o, outs[0]), f"{what}: rank {r} differs"


def _rel_err(got, want):
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


# ------------------------------------------------------------ all_to_all --


def _expected_a2a(ranks, dtype, index):
    """What shard ``index`` of a group of ``ranks`` (shard order) holds
    after the exchange: block ``index`` of every shard, in shard order."""
    n = len(ranks)
    parts = [R.a2a_block(r, n, dtype).reshape(n, 2, 3)[index]
             for r in ranks]
    return torch.cat(parts)


def _group_ranks(mesh, axes, rank):
    """The global ranks of ``rank``'s group over ``axes`` in shard order:
    row-major over (data, model), the flat index over ``axes`` major to
    minor."""
    coords = dict(zip(R.NAMES, divmod(rank, mesh[1])))
    sizes = dict(zip(R.NAMES, mesh))
    out = []
    for i in range(int(np.prod([sizes[a] for a in axes]))):
        c = dict(coords)
        for a in reversed(axes):
            c[a] = i % sizes[a]
            i //= sizes[a]
        out.append(c["data"] * mesh[1] + c["model"])
    return out


@pytest.mark.parametrize("world,mesh", [(w, m) for w, ms in MESHES.items()
                                        for m in ms])
@pytest.mark.parametrize("axes", A2A_AXES, ids="-".join)
def test_all_to_all_in_shard_order(runs, world, mesh, axes):
    for rank, out in enumerate(runs.ranks[world]):
        a2a = out["a2a"][mesh]
        for dtype in (torch.float32, torch.bfloat16, torch.bool):
            ranks, got = a2a[(axes, str(dtype))]
            want_ranks = _group_ranks(mesh, axes, rank)
            assert list(ranks) == want_ranks, (axes, ranks)
            want = _expected_a2a(want_ranks, dtype, want_ranks.index(rank))
            assert got.dtype == dtype and torch.equal(got, want), (
                rank, axes, dtype)


@pytest.mark.parametrize("world,mesh", [(w, m) for w, ms in MESHES.items()
                                        for m in ms])
def test_grid_all_to_all_is_the_flat_exchange(runs, world, mesh):
    """The reference's ``_grid_a2a`` (one exchange a mesh axis, minor
    first) composes to one flat exchange over the axes' group."""
    for out in runs.ranks[world]:
        grid, flat = out["a2a"][mesh]["grid"]
        assert torch.equal(grid, flat)


# ------------------------------------------------------------ the layer --


@pytest.mark.parametrize("world,key", [(w, k) for w, k, _ in LAYER_CASES])
def test_apply_moe_matches_jax(runs, world, key):
    want = runs.jax["layers"][key]
    outs = [r["layers"][key] for r in runs.ranks[world]]
    _same_on_every_rank([o["y"] for o in outs], key)
    assert len({o["aux"] for o in outs}) == 1, key
    got = outs[0]
    assert got["path"] == want["path"], (key, got["path"], want["path"])
    assert got["y"].shape == want["y"].shape
    err = _rel_err(got["y"], want["y"])
    assert err <= 1e-5, (key, err)
    assert abs(got["aux"] - want["aux"]) <= 1e-6 * max(1.0, abs(
        want["aux"])), (key, got["aux"], want["aux"])


def test_layer_cases_cover_every_path_and_padding(runs):
    """Every path (the fallbacks included) occurs, and at (1, 4) E=6
    pads the experts to 8: each rank holds 2."""
    paths = {runs.jax["layers"][k]["path"] for _, k, _ in LAYER_CASES}
    assert paths == {"etp", "alltoall", "local"}
    key = _layer_key((1, 4), "alltoall", "tp", 6, 1.25)
    for r in runs.ranks[4]:
        assert r["layers"][key]["parts"]["w1"] == (2, D, DFF)


# ------------------------------------------------------- the model level --


@pytest.mark.parametrize("world,key", MODEL_CASES)
def test_generate_under_mesh_equals_single_device(runs, world, key):
    name = key.split("-")[0]
    outs = [r["models"][key] for r in runs.ranks[world]]
    _same_on_every_rank([o["tokens"] for o in outs], key)
    _same_on_every_rank([o["step_logits"] for o in outs], key)
    toks, logits = runs.single[name]
    assert np.array_equal(outs[0]["tokens"], toks), key
    assert _rel_err(outs[0]["step_logits"], logits) <= 1e-5


@pytest.mark.parametrize("world,key", MODEL_CASES)
def test_sharded_prefill_matches_jax(runs, world, key):
    outs = [r["models"][key] for r in runs.ranks[world]]
    _same_on_every_rank([o["logits"] for o in outs], key)
    err = _rel_err(outs[0]["logits"], runs.jax["models"][key]["logits"])
    assert err <= 1e-5, (key, err)
    E = outs[0]["w1"][1]
    name = key.split("-")[0]
    _, cfg = _model_cfgs(name)
    assert outs[0]["w1"][0] == cfg.n_layers - cfg.n_dense_layers
    assert E < cfg.moe.n_experts or outs[0]["w1"][-1] < cfg.moe.d_expert, (
        f"{key}: the rank holds every expert whole")


# -------------------------------------------------------- the shard rule --


def _stub(shape, names=("data", "model"), coords=None):
    """A mesh of ``shape`` read only through ``shape`` (the rule), and
    ``index`` (this rank's part)."""
    coords = coords or {a: 0 for a in names}

    def index(axes):
        i = 0
        for a in axes:
            i = i * dict(zip(names, shape))[a] + coords[a]
        return i
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names,
                           index=index,
                           size=lambda axes: int(np.prod(
                               [dict(zip(names, shape))[a] for a in axes])))


RULE_MESHES = [((2, 4), ("data", "model")), ((1, 4), ("data", "model")),
               ((4, 2), ("data", "model")), ((2, 2, 4), ("pod", "data",
                                                         "model")),
               ((8, 1), ("data", "model"))]


@pytest.mark.parametrize("shape,names", RULE_MESHES)
@pytest.mark.parametrize("E", (4, 6, 8, 16, 256))
def test_ep_axes_for_matches_jax(shape, names, E):
    stub = _stub(shape, names)
    dp = tuple(a for a in names if a != "model")
    got = moe._ep_axes_for(E, DistCtx(mesh=stub, dp=dp))
    want = jmoe._ep_axes_for(E, JaxCtx(mesh=stub, dp=dp, tp="model"))
    assert got == want


@pytest.mark.parametrize("shape,names", RULE_MESHES)
@pytest.mark.parametrize("impl,ep", IMPLS)
def test_expert_spec_matches_param_specs(shape, names, impl, ep):
    """The port's cut of each expert leaf against the JAX package's
    ``param_specs`` (without FSDP) for a layer-stacked leaf, where E and
    d_expert divide; where they do not, the reference's spec replicates
    the leaf and its ``apply_moe`` pads the experts (``alltoall``) or
    gathers them (the local path), while the port keeps the padded part
    it runs on."""
    stub = _stub(shape, names)
    dp = tuple(a for a in names if a != "model")
    jcfg = jax_config("deepseek-v3-671b", reduced=True).replace(fsdp=False)
    m = dataclasses.replace(jcfg.moe, n_experts=16, d_expert=64, impl=impl,
                            ep=ep)
    jcfg = jcfg.replace(moe=m)
    cfg = SimpleNamespace(moe=MoEConfig(**dataclasses.asdict(m)))
    L, d = 3, jcfg.d_model
    tree = {"segments": ({"moe": {
        "w1": jax.ShapeDtypeStruct((L, 16, d, 64), np.float32),
        "w3": jax.ShapeDtypeStruct((L, 16, d, 64), np.float32),
        "w2": jax.ShapeDtypeStruct((L, 16, 64, d), np.float32)}},)}
    specs = param_specs(tree, jcfg, stub, dp)["segments"][0]["moe"]
    for name in moe.EXPERT_LEAVES:
        want = tuple(None if a is None else (a,) if isinstance(a, str)
                     else tuple(a) for a in specs[name])
        got = expert_spec(cfg, DistCtx(mesh=stub, dp=dp), name, 4)
        assert got == want, (name, got, want)


@pytest.mark.parametrize("impl,ep", IMPLS)
def test_expert_parts_tile_the_stack(impl, ep):
    """Every rank's part of a (2, 4) mesh put together is the whole
    stack, padded with zero experts where E does not divide; a draw cut
    as it is drawn equals the same part of the uncut draw."""
    m = MoEConfig(n_experts=6, top_k=2, d_expert=8, impl=impl, ep=ep)
    gen = torch.Generator().manual_seed(3)
    whole = moe.init_moe(gen, SimpleNamespace(moe=m, d_model=4),
                         torch.float32)
    parts = {}
    for data in range(2):
        for model in range(4):
            ctx = DistCtx(mesh=_stub((2, 4), coords={"data": data,
                                                     "model": model}))
            drawn = moe.init_moe(torch.Generator().manual_seed(3),
                                 SimpleNamespace(moe=m, d_model=4),
                                 torch.float32, ctx)
            for name in moe.EXPERT_LEAVES:
                part = moe.expert_part(m, ctx, name)
                assert torch.equal(drawn[name], part.take(whole[name]))
                parts.setdefault(name, {})[(part.lo, part.hi)] = \
                    drawn[name]
            assert torch.equal(drawn["router"], whole["router"])
    for name in moe.EXPERT_LEAVES:
        part = moe.expert_part(m, ctx, name)
        cat = torch.cat([w for _, w in sorted(parts[name].items())],
                        dim=part.axis)
        ext = whole[name].shape[part.axis]
        assert torch.equal(cat.narrow(part.axis, 0, ext), whole[name])
        assert not cat.narrow(part.axis, ext,
                              cat.shape[part.axis] - ext).any()


def test_dense_init_cuts_pieces_as_drawn(monkeypatch):
    """Above DRAW_WHOLE a leaf is drawn in pieces: the kept part, on the
    pieces' axis and across it, holds the bits of the uncut draw."""
    from repro_torch.models import common
    monkeypatch.setattr(common, "DRAW_WHOLE", 50)
    monkeypatch.setattr(common, "DRAW_PIECE", 24)
    whole = common.dense_init(torch.Generator().manual_seed(5), (7, 3, 4),
                              torch.float32)
    for part in (common.Part(-3, 2, 6, ("model",)),
                 common.Part(-3, 4, 8, ("model",)),
                 common.Part(-1, 1, 3, ("model",))):
        got = common.dense_init(torch.Generator().manual_seed(5), (7, 3, 4),
                                torch.float32, part=part)
        assert torch.equal(got, part.take(whole)), part
