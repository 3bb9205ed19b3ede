"""The dense layers' tensor-parallel, FSDP and sequence-parallel layouts
(``launch/sharding.py`` and the model modules under a mesh) against the
JAX package's GSPMD programs, in gloo worlds of 2 and 4 ranks on the CPU.

Each world is one ``torch.multiprocessing.spawn`` whose ranks run every
case of that world (``_torch_tp_ranks``); the JAX side runs meanwhile in
one process of its own on 8 forced host devices (``_torch_tp_jax``):
every case's prefill, decode step and ``train_step`` jitted with
``param_specs`` / ``batch_specs`` / ``cache_specs_tree`` /
``opt_specs`` as ``launch/dryrun.py`` lays them out. The bars, in f32:

- the greedy tokens equal, the prefill's and every decode step's logits
  within 1e-5 of their largest magnitude; each train step's loss and
  grad norm within 1e-5 relative; after the steps each rank's part of
  every parameter and optimizer leaf within 1e-5 of the largest
  magnitude of the same slice of JAX's global array, the decode cache's
  part likewise; every replicated leaf, and each part, the same bits on
  every rank that holds it; the loss and grad norm the same bits on
  every rank;
- each rank holds exactly the part ``param_spec`` gives it;
- configs (reduced): granite (tied embeddings; vocab 512 and 510, which
  does not divide ``model``), qwen (qkv bias), Mixtral with ``fsdp`` and
  ``seq_shard``, DeepSeek-V3 (MLA, shared experts, MTP, adafactor) with
  ``fsdp``; meshes (1, 2), (2, 1), (2, 2) and (1, 4) (at tp = 4
  Mixtral's 2 kv heads of 32 split over the ranks: the kv-head
  fallback); and, serving only, Mixtral with windows of 8 and 16 on
  (1, 2) and (1, 4), whose decode ring the 16-token prompt fills or
  wraps;
- a batch of 3 rows on (2, 2) does not divide ``data``: the batch stays
  whole, and its train steps are held to the port's single-device steps
  (the JAX side's sharded step has a wrong embed gradient there,
  ROADMAP.md section 3); its decode cache of 20 positions is cut on the
  sequence over ``data`` (the context-parallel cache);
- serving only, a batch of 1 row (the reference's ``long_500k`` shape)
  on (2, 1) and (2, 2), whose decode cache is context-parallel: each
  rank holds its block of the sequence (granite's full cache of 20
  positions, DeepSeek-V3's latent cache, the Mixtral rings of 8 and 16
  slots, wrapped and filled) and the ranks' softmax states are merged;
  and qwen with a prompt of 15, whose cache of 19 positions does not
  divide and stays whole;
- ``ShardGroup.reduce_scatter`` against ``jax.vjp`` of
  ``psum_scatter``.

The spec-parity tests need no ranks: for every config in ``configs/`` at
its full shapes, on five meshes given as shape maps, the port's
``param_spec``, ``opt_spec``, ``batch_spec`` and ``cache_spec`` against
the reference's ``param_specs``, ``opt_specs``, ``batch_specs`` and
``cache_specs_tree``, leaf for leaf (the context-parallel branch
included). The ssm, hybrid, encdec and vlm families' cases
are in ``test_torch_tp_families.py``.
"""
import dataclasses
import functools
import tempfile
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import _torch_ep_ranks as R  # noqa: E402
import _torch_tp_ranks as TR  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch.sharding import (batch_specs,  # noqa: E402
                                   cache_specs_tree, opt_specs, param_specs)
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import list_archs  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.serve import init_params  # noqa: E402
from repro_torch.models.common import DistCtx  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.tree import leaves  # noqa: E402

SEED = 0
ADAMW = ("adamw", {"lr": 1e-3, "eps": 1e-4})
ADAFACTOR = ("adafactor", {"lr": 1e-3})
# qwen's q / k / v biases start at zero, and a bias entry's gradient sits
# near 1e-4: at eps 1e-4 adamw's step there is about g / eps, which turns
# another order of the f32 sums (1e-9 of a gradient) into up to 3.5e-5 of
# the leaf's largest entry after 2 steps against JAX's; at 1e-3 into up
# to 5.1e-6.
ADAMW_QWEN = ("adamw", {"lr": 1e-3, "eps": 1e-3})
# name -> (config, overrides, optimizer)
MODELS = {
    "granite": ("granite-3-2b", {}, ADAMW),
    "granite510": ("granite-3-2b", {"vocab_size": 510}, ADAMW),
    "qwen": ("qwen1.5-0.5b", {}, ADAMW_QWEN),
    "mixtral": ("mixtral-8x7b", {"fsdp": True, "seq_shard": True}, ADAMW),
    "deepseek": ("deepseek-v3-671b", {"fsdp": True}, ADAFACTOR),
    # The decode ring wrapping under tensor and sequence parallelism:
    # windows of 8 (the prefill's 16 tokens already wrap it) and of 16
    # (the prompt fills it, and the first decode step overwrites slot 0,
    # as the card's 4096-token prompts fill Mixtral's 4096).
    "mixtral_ring8": ("mixtral-8x7b", {"fsdp": True, "seq_shard": True,
                                       "sliding_window": 8}, ADAMW),
    "mixtral_ring16": ("mixtral-8x7b", {"fsdp": True, "seq_shard": True,
                                        "sliding_window": 16}, ADAMW),
}
# models whose cases serve only (no train step); so do the cases of B = 1
SERVE_ONLY = ("mixtral_ring8", "mixtral_ring16")
# (world, mesh, model, microbatch, B[, prompt length]): 2 train steps of
# B x 16 tokens, a prefill of B x 16 (or the prompt length) and 3 decode
# steps.
CASES = [(2, (1, 2), "granite", 1, 4), (2, (1, 2), "qwen", 1, 4),
         (2, (1, 2), "mixtral", 1, 4), (2, (1, 2), "deepseek", 1, 4),
         (2, (2, 1), "granite", 2, 4), (2, (2, 1), "qwen", 1, 4),
         (2, (2, 1), "mixtral", 2, 4), (2, (2, 1), "deepseek", 1, 4),
         (4, (2, 2), "granite", 1, 4), (4, (2, 2), "granite510", 1, 4),
         (4, (2, 2), "qwen", 1, 4), (4, (2, 2), "mixtral", 2, 4),
         (4, (2, 2), "deepseek", 2, 4), (4, (1, 4), "granite", 1, 4),
         (4, (1, 4), "qwen", 1, 4), (4, (1, 4), "mixtral", 1, 4),
         (4, (1, 4), "deepseek", 1, 4),
         # 3 rows do not divide data = 2: the batch stays whole and the
         # decode cache's 20 positions are cut over data.
         (4, (2, 2), "granite", 1, 3),
         (2, (1, 2), "mixtral_ring8", 1, 4),
         (2, (1, 2), "mixtral_ring16", 1, 4),
         (4, (1, 4), "mixtral_ring8", 1, 4),
         (4, (1, 4), "mixtral_ring16", 1, 4),
         # One row: the context-parallel cache (S + DECODE + 1 = 20
         # positions, or the ring's 8 and 16 slots, over data = 2); with a
         # prompt of 15 the 19 positions do not divide and stay whole.
         (2, (2, 1), "granite", 1, 1), (2, (2, 1), "qwen", 1, 1, 15),
         (2, (2, 1), "mixtral_ring8", 1, 1),
         (2, (2, 1), "mixtral_ring16", 1, 1),
         (4, (2, 2), "mixtral_ring8", 1, 1),
         (4, (2, 2), "mixtral_ring16", 1, 1),
         (4, (2, 2), "deepseek", 1, 1)]
S, STEPS, DECODE = 16, 2, 3
WORLDS = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
GROUP_AXES = (("model",), ("data",), ("data", "model"), ("model", "data"))


def _key(mesh, model, mb, b, s=S):
    return f"{model}-{mesh[0]}x{mesh[1]}-mb{mb}-b{b}" + (
        f"-s{s}" if s != S else "")


def _serves_only(model, b):
    return model in SERVE_ONLY or b == 1


CASE_KEYS = [(c[0], _key(*c[1:]), c) for c in CASES]
# held to one device
NOT_JAX = {k for _, k, c in CASE_KEYS if c[4] % c[1][0]
           and not _serves_only(c[2], c[4])}


def _over(model, mb):
    _, over, _ = MODELS[model]
    return dict(over, dtype="float32", microbatch=mb)


def _cfg(model, mb=1):
    name, _, _ = MODELS[model]
    return get_config(name, reduced=True).replace(**_over(model, mb))


def _draws(key, vocab, b, s=S):
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, size=(b, S)).astype(np.int32)
        labels = rng.integers(0, vocab, size=(b, S)).astype(np.int32)
        labels[:, ::5] = -1
        batches.append({"tokens": toks, "labels": labels})
    prompt = {"tokens": rng.integers(0, vocab, size=(b, s)).astype(np.int32)}
    return batches, prompt


@functools.lru_cache(maxsize=None)
def _whole_draw(model):
    return [a.numpy() for a in leaves(init_params(
        build_model(_cfg(model)), seed=SEED, device="cpu"))]


def _cache_shapes(model, b, s=S):
    """The whole decode cache's leaf shapes after the prefill of b x s
    (room for DECODE steps), from a single-device prefill of the port."""
    m = build_model(_cfg(model))
    m.decode_room = DECODE + 1
    params = init_params(m, seed=SEED, device="cpu")
    with torch.no_grad():
        _, cache = m.prefill(params, {"tokens": torch.zeros(
            (b, s), dtype=torch.int32)})
    return [tuple(a.shape) for a in leaves(cache)]


def _specs():
    port, jx = {}, {}
    for _, key, (_, mesh, model, mb, b, *s) in CASE_KEYS:
        cfg = _cfg(model, mb)
        batches, prompt = _draws(key, cfg.vocab_size, b, *s)
        common = {"name": MODELS[model][0], "over": _over(model, mb),
                  "mesh": mesh, "batches": batches, "prompt": prompt,
                  "steps": DECODE, "optimizer": MODELS[model][2]}
        train = not _serves_only(model, b)
        port[key] = dict(common, seed=SEED, single=key in NOT_JAX,
                         cache_shapes=_cache_shapes(model, b, *s),
                         train=train)
        # (the NOT_JAX cases' serving is held to JAX all the same)
        jx[key] = dict(common, leaves=_whole_draw(model),
                       train=train and key not in NOT_JAX)
    return port, jx


def _coll_specs(mesh):
    out = {}
    for axes in GROUP_AXES:
        n = int(np.prod([dict(zip(R.NAMES, mesh))[a] for a in axes]))
        rng = np.random.default_rng(zlib.crc32(repr((mesh, axes)).encode()))
        rows = 2 * n
        out[axes] = {"x": rng.integers(-8, 9, size=(n * rows, 3)).astype(
            np.float32), "ct": rng.integers(-8, 9, size=(rows, 3)).astype(
            np.float32)}
    return out


@pytest.fixture(scope="module")
def runs():
    """Both worlds' spawns and the JAX process, side by side."""
    port, jx = _specs()
    colls = {m: _coll_specs(m) for ms in WORLDS.values() for m in ms}
    jax_colls = {m: {axes: dict(spec, mesh=m) for axes, spec in by.items()}
                 for m, by in colls.items()}
    worlds = {world: {
        "models": {k: port[k] for w, k, _ in CASE_KEYS if w == world},
        "collectives": {m: {"mesh": m, "groups": colls[m]} for m in meshes},
        "refusal": ({"mixtral": {"name": "mixtral-8x7b",
                                 "over": _over("mixtral", 1), "mesh": (1, 2)}}
                    if world == 2 else {})}
        for world, meshes in WORLDS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        ranks, jax_out = TR.run({"models": jx, "collectives": jax_colls},
                                worlds, tmp)
    return SimpleNamespace(ranks=ranks, jax=jax_out, colls=colls)


MODEL_CASES = [(w, k) for w, k, _ in CASE_KEYS]
TRAIN_CASES = [(w, k) for w, k, c in CASE_KEYS
               if not _serves_only(c[2], c[4])]


def _outs(runs, world, key):
    return [r["models"][key] for r in runs.ranks[world]]


@pytest.mark.parametrize("world,key", MODEL_CASES)
def test_serving_under_mesh_matches_jax(runs, world, key):
    """Greedy generate under the mesh: every rank the same tokens and
    logits, JAX's sharded prefill and decode steps' (tokens equal, logits
    within 1e-5), and each rank's final cache its cache_spec part of
    JAX's (a block of the sequence where the batch does not divide:
    the context-parallel cache)."""
    outs = _outs(runs, world, key)
    want = runs.jax["models"][key]
    for r, o in enumerate(outs):
        assert np.array_equal(o["tokens"], outs[0]["tokens"]), (key, r)
        assert np.array_equal(o["logits"], outs[0]["logits"]), (key, r)
    assert np.array_equal(outs[0]["tokens"], want["tokens"]), key
    assert TR.rel(outs[0]["logits"], want["logits"]) <= 1e-5, key
    wc = jax.tree_util.tree_leaves(want["cache"])
    TR.check_parts([{"cache": o["cache"], "cache_parts": o["cache_parts"]}
                  for o in outs], key, "cache", [np.asarray(a) for a in wc])


@pytest.mark.parametrize("world,key", TRAIN_CASES)
def test_train_under_mesh_matches_jax(runs, world, key):
    """The train steps under the mesh: the loss and grad norm the same
    bits on every rank and JAX's (or, where the batch does not divide,
    the port's single-device steps') within 1e-5; every parameter and
    optimizer leaf's part within 1e-5 of the same slice of JAX's
    state."""
    outs = _outs(runs, world, key)
    for r, o in enumerate(outs):
        assert o["loss"] == outs[0]["loss"], (key, r)
        assert o["grad_norm"] == outs[0]["grad_norm"], (key, r)
    if key in NOT_JAX:
        want = outs[0]["single"]
    else:
        want = runs.jax["models"][key]
    for name in ("loss", "grad_norm"):
        for s, (a, b) in enumerate(zip(outs[0][name], want[name])):
            assert abs(a - b) <= 1e-5 * abs(b), (key, name, s, a, b)
    TR.check_parts(outs, key, "params", want["params"])
    if key not in NOT_JAX:
        TR.check_parts(outs, key, "opt", want["opt"])


@pytest.mark.parametrize("world,key", MODEL_CASES)
def test_each_rank_holds_its_param_spec_part(runs, world, key):
    """Every leaf a rank holds has the shape of its ``param_spec`` part,
    and is that part of the seed's whole draw (before training: the
    serving draw's parts are held to the whole draw's slices through the
    cache and logits; here the shapes)."""
    for r, o in enumerate(_outs(runs, world, key)):
        assert all(o["spec_ok"]), (key, r, o["spec_ok"].index(False))


COLL_CASES = [(w, m, axes) for w, ms in WORLDS.items() for m in ms
              for axes in GROUP_AXES]


@pytest.mark.parametrize("world,mesh,axes", COLL_CASES,
                         ids=[f"{m[0]}x{m[1]}-{'-'.join(a)}"
                              for _, m, a in COLL_CASES])
def test_reduce_scatter_matches_jax_vjp(runs, world, mesh, axes):
    """reduce_scatter's output and input gradient: JAX's psum_scatter
    and its vjp cut to this rank (integer inputs: exact); along dim 1
    the same sums."""
    wy, wg = runs.jax["collectives"][mesh][axes]
    n = int(np.prod([dict(zip(R.NAMES, mesh))[a] for a in axes]))
    rows = 2 * n
    for rank, out in enumerate(runs.ranks[world]):
        got = out["collectives"][mesh][axes]
        i = got["index"]
        assert np.array_equal(got["y"], wy[i * 2:(i + 1) * 2]), rank
        assert np.array_equal(got["grad"], wg[i * rows:(i + 1) * rows])
        assert np.array_equal(got["y_dim1"], got["y"].T), rank


def test_whole_dense_leaves_are_refused_by_name(runs):
    """Whole parameters given to a cutting mesh: the first dense leaf
    that is not this rank's part is named."""
    for r, out in enumerate(runs.ranks[2]):
        msg = out["refusal"]["mixtral"]
        assert msg is not None and "embed" in msg and "init_params" in msg, (
            r, msg)


# ------------------------------------------------ spec parity, no ranks --

PARITY_MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (4, 4)]
CONFIGS = list_archs()


def _stub(shape):
    sizes = dict(zip(R.NAMES, shape))
    return SimpleNamespace(shape=sizes, axis_names=R.NAMES,
                           index=lambda axes: 0,
                           size=lambda axes: int(np.prod(
                               [sizes[a] for a in axes])))


def _norm(spec):
    """A PartitionSpec's entries as the port's: tuples of axes or
    None."""
    return tuple(None if a is None else (a,) if isinstance(a, str)
                 else tuple(a) for a in spec)


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                   for p in path), leaf) for path, leaf in flat]


@functools.lru_cache(maxsize=None)
def _full(name):
    cfg = jax_config(name)
    model = jax_build(cfg)
    return cfg, model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", PARITY_MESHES)
def test_param_and_opt_specs_match_the_reference(name, mesh):
    """param_spec for every leaf of the full config, and opt_spec for
    every adamw and adafactor state leaf, against param_specs /
    opt_specs."""
    jcfg, _, params = _full(name)
    cfg = get_config(name)
    stub = _stub(mesh)
    ctx = DistCtx(mesh=stub, dp=("data",))
    pspecs = param_specs(params, jcfg, stub, ("data",))
    shapes = {}
    for (path, leaf), (_, spec) in zip(_paths(params), _paths(pspecs)):
        got = SH.param_spec(cfg, ctx, path, leaf.shape)
        assert got == _norm(spec), (name, path, got, spec)
        shapes[path] = leaf.shape
    for opt_name in ("adamw", "adafactor"):
        state = jax.eval_shape(joptim.build_optimizer(opt_name, 1e-3).init,
                               params)
        ospecs = opt_specs(state, pspecs)
        for (path, leaf), (_, spec) in zip(_paths(state), _paths(ospecs)):
            if opt_name == "adamw":
                ppath, key = path[1:], "m"
            else:
                ppath, key = path[1:-1], path[-1]
            got = SH.opt_spec(SH.param_spec(cfg, ctx, ppath, shapes[ppath]),
                              key, leaf.ndim)
            assert got == _norm(spec), (name, opt_name, path, got, spec)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", PARITY_MESHES)
def test_batch_and_cache_specs_match_the_reference(name, mesh):
    """batch_spec and cache_spec against batch_specs and
    cache_specs_tree, leaf for leaf, for a batch that divides the data
    axes and one that does not (the reference's context-parallel cache:
    the sequence over data)."""
    jcfg, model, _ = _full(name)
    stub = _stub(mesh)
    ctx = DistCtx(mesh=stub, dp=("data",))
    for B in (mesh[0] * 2, mesh[0] * 2 + 1):
        batch = {"tokens": jax.ShapeDtypeStruct((B, 64), np.int32),
                 "labels": jax.ShapeDtypeStruct((B, 64), np.int32)}
        for (path, leaf), (_, spec) in zip(
                _paths(batch), _paths(batch_specs(batch, stub, ("data",)))):
            assert SH.batch_spec(ctx, leaf.shape) == _norm(spec), (B, path)
        cache = jax.eval_shape(lambda: model.init_cache(B, 64))
        for (path, leaf), (_, spec) in zip(
                _paths(cache), _paths(cache_specs_tree(cache, stub,
                                                       ("data",)))):
            got = SH.cache_spec(ctx, path, leaf.shape)
            assert got == _norm(spec), (name, B, path, got, spec)


def test_held_spec_is_param_spec_but_for_the_waiting_families():
    """held_spec is param_spec for every leaf of every family on every
    parity mesh, but for the shared experts of an alltoall MoE (the
    reference's expert branch takes them, the port holds them by their
    own rule)."""
    seen = set()
    for name, mesh in ((n, m) for n in CONFIGS for m in PARITY_MESHES):
        ctx = DistCtx(mesh=_stub(mesh), dp=("data",))
        cfg = get_config(name)
        _, _, params = _full(name)
        for path, leaf in _paths(params):
            held = SH.held_spec(cfg, ctx, path, leaf.shape)
            spec = SH.param_spec(cfg, ctx, path, leaf.shape)
            if "shared" in path and cfg.moe and cfg.moe.impl == "alltoall":
                seen.add(name)
                assert held == SH.param_spec(
                    dataclasses.replace(cfg, moe=dataclasses.replace(
                        cfg.moe, impl="dense")), ctx, path, leaf.shape)
            else:
                assert held == spec, (name, mesh, path, held, spec)
    assert seen == {"deepseek-v3-671b"}
