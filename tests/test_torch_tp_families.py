"""The ssm (RWKV-6), hybrid (Zamba2), encdec (Whisper) and vlm (InternVL2)
families' tensor-parallel, FSDP and sequence-parallel layouts
(``launch/sharding.py`` and ``models/rwkv.py``, ``models/mamba.py``,
``models/transformer.py``, ``models/model.py`` under a mesh) against the
JAX package's GSPMD programs, in gloo worlds of 2 and 4 ranks on the CPU,
with the harness and the bars of ``test_torch_tp.py``:

- the greedy tokens equal, the prefill's and every decode step's logits
  within 1e-5 of their largest magnitude; each rank's final decode cache
  (the rwkv state ``s`` and the Mamba2 state ``h`` on their heads, the
  cross cache ``ck`` / ``cv`` and the shared block's k / v on their kv
  heads) its ``cache_spec`` part of JAX's, within 1e-5;
- each train step's loss and grad norm within 1e-5 relative, the same
  bits on every rank; after the steps each rank's part of every
  parameter and adamw first-moment leaf within 1e-5 of the same slice of
  JAX's, of every second-moment leaf (the gradient squared) within
  2e-5, and every leaf held whole (``w0``, ``ln_x``, ``A_log``, ``D``,
  ``dt_bias``, the norms) the same bits on every rank;
- each rank holds exactly the part ``param_spec`` gives it, and a zeroed
  ``init_cache`` under the mesh serves a step;
- configs (reduced, f32): RWKV-6 and Zamba2 with ``fsdp`` and
  ``seq_shard``, Whisper and InternVL2 with ``fsdp``; the prefill is
  B x 16 tokens (after InternVL2's 16 patches; Whisper's encoder reads 8
  frames), 3 decode steps and 2 train steps. At (1, 4) InternVL2's 2 kv
  heads split over the ranks (the kv-head fallback);
- serving only, a batch of 1 row on (2, 2), whose decode cache is
  context-parallel: each rank holds its block of the sequence of
  Whisper's self-attention cache (20 positions) and cross cache
  (``ck`` / ``cv``: 4 of the 8 frames, ``cvalid`` whole), of Zamba2's
  shared block's cache (its Mamba2 states as before), and of InternVL2's
  ring of 16 slots (``with_sliding_window(16)``: the 32 prefill
  positions wrap it), and the ranks' softmax states are merged.
"""
import tempfile
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import _torch_tp_ranks as TR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import init_params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils.tree import leaves  # noqa: E402

SEED = 0
# eps 1e-3, as test_torch_tp.py's qwen: Mamba2's conv_b starts at zero and
# its gradient's entries sit near 1e-4, where adamw's step at eps 1e-4 is
# about 10 g, which turns another order of the f32 sums into up to
# 2.8e-5 of the leaf's largest entry after 2 steps (the single-device
# port against JAX's sharded step as much as the mesh's).
ADAMW = ("adamw", {"lr": 1e-3, "eps": 1e-3})
# The gradient is held to 1e-5 through adamw's first moment; the second
# moment, its square, to twice that: (g (1 + e))^2 = g^2 (1 + 2e + e^2).
# (RWKV-6's u at (1, 4): v 1.24e-5 off JAX's, the single-device port's
# 1.06e-5, m within 5e-6.)
M_BAR, V_BAR = 1e-5, 2e-5
# name -> (config, overrides)
MODELS = {"rwkv": ("rwkv6-7b", {"fsdp": True, "seq_shard": True}),
          "zamba": ("zamba2-1.2b", {"fsdp": True, "seq_shard": True}),
          "whisper": ("whisper-base", {"fsdp": True}),
          "internvl": ("internvl2-26b", {"fsdp": True}),
          "internvl_ring": ("internvl2-26b", {"fsdp": True,
                                              "sliding_window": 16})}
# (world, mesh, model[, batch]): batches of B rows, or of the batch given
# (1: serving only, over the context-parallel cache)
CASES = [(2, (1, 2), "rwkv"), (4, (2, 2), "rwkv"), (4, (1, 4), "rwkv"),
         (2, (1, 2), "zamba"), (4, (2, 2), "zamba"),
         (2, (1, 2), "whisper"), (4, (2, 2), "whisper"),
         (2, (1, 2), "internvl"), (4, (2, 2), "internvl"),
         (4, (1, 4), "internvl"),
         (4, (2, 2), "whisper", 1), (4, (2, 2), "zamba", 1),
         (4, (2, 2), "internvl_ring", 1)]
B, S, STEPS, DECODE = 4, 16, 2, 3
# Leaves every rank holds whole whose work each rank runs on a part
# (their cotangent summed over tp): they must stay the same bits.
SLICED = {"rwkv": ("w0", "ln_x"), "zamba": ("A_log", "D", "dt_bias")}


def _key(mesh, model, b=B):
    return f"{model}-{mesh[0]}x{mesh[1]}" + (f"-b{b}" if b != B else "")


def _batch(case):
    return case[3] if len(case) > 3 else B


CASE_KEYS = [(c[0], _key(*c[1:]), c) for c in CASES]


def _over(model):
    return dict(MODELS[model][1], dtype="float32", microbatch=1)


def _cfg(model):
    return get_config(MODELS[model][0], reduced=True).replace(**_over(model))


def _inputs(rng, cfg, b):
    """The family's inputs beside the tokens."""
    if cfg.family == "encdec":
        return {"enc_embeds": rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patch_embeds": rng.standard_normal(
            (b, cfg.encoder.n_prefix, cfg.d_model)).astype(np.float32)}
    return {}


def _draws(key, cfg, b):
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
            np.int32)
        labels[:, ::5] = -1
        batches.append(dict(tokens=toks, labels=labels,
                            **_inputs(rng, cfg, B)))
    prompt = dict(tokens=rng.integers(0, cfg.vocab_size, size=(b, S)).astype(
        np.int32), **_inputs(rng, cfg, b))
    return batches, prompt


def _whole(model, prompt):
    """(the seed's whole draw as numpy leaves, the whole decode cache's
    leaf shapes after the prefill of ``prompt`` with room for DECODE
    steps), on one device."""
    m = build_model(_cfg(model))
    m.decode_room = DECODE + 1
    params = init_params(m, seed=SEED, device="cpu")
    with torch.no_grad():
        _, cache = m.prefill(params, {k: torch.as_tensor(v)
                                      for k, v in prompt.items()})
    return ([a.numpy() for a in leaves(params)],
            [tuple(a.shape) for a in leaves(cache)])


def _specs():
    port, jx = {}, {}
    for _, key, case in CASE_KEYS:
        _, mesh, model = case[:3]
        b = _batch(case)
        batches, prompt = _draws(key, _cfg(model), b)
        whole, cache_shapes = _whole(model, prompt)
        common = {"name": MODELS[model][0], "over": _over(model),
                  "mesh": mesh, "batches": batches, "prompt": prompt,
                  "steps": DECODE, "optimizer": ADAMW, "train": b == B}
        port[key] = dict(common, seed=SEED, single=False,
                         cache_shapes=cache_shapes)
        jx[key] = dict(common, leaves=whole)
    return port, jx


@pytest.fixture(scope="module")
def runs():
    """Both worlds' spawns and the JAX process, side by side."""
    port, jx = _specs()
    worlds = {world: {"models": {k: port[k] for w, k, _ in CASE_KEYS
                                 if w == world}} for world in (2, 4)}
    with tempfile.TemporaryDirectory() as tmp:
        ranks, jax_out = TR.run({"models": jx, "collectives": {}}, worlds,
                                tmp)
    return SimpleNamespace(ranks=ranks, jax=jax_out)


def _outs(runs, world, key):
    return [r["models"][key] for r in runs.ranks[world]]


MODEL_CASES = [(w, k) for w, k, _ in CASE_KEYS]
TRAIN_CASES = [(w, k) for w, k, c in CASE_KEYS if _batch(c) == B]


@pytest.mark.parametrize("world,key", MODEL_CASES)
def test_serving_under_mesh_matches_jax(runs, world, key):
    """Greedy generate under the mesh: every rank the same tokens and
    logits, JAX's sharded prefill and decode steps' (tokens equal, logits
    within 1e-5), and each rank's final cache its cache_spec part of
    JAX's."""
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
    bits on every rank and JAX's within 1e-5; every parameter and
    optimizer leaf's part within 1e-5 of the same slice of JAX's state,
    ranks holding the same part (every rank, for a leaf held whole) the
    same bits."""
    outs = _outs(runs, world, key)
    for r, o in enumerate(outs):
        assert o["loss"] == outs[0]["loss"], (key, r)
        assert o["grad_norm"] == outs[0]["grad_norm"], (key, r)
    want = runs.jax["models"][key]
    for name in ("loss", "grad_norm"):
        for s, (a, b) in enumerate(zip(outs[0][name], want[name])):
            assert abs(a - b) <= 1e-5 * abs(b), (key, name, s, a, b)
    TR.check_parts(outs, key, "params", want["params"])
    n = len(want["params"])       # adamw's {"m", "v"}: m's leaves first
    TR.check_parts(outs, key, "opt", want["opt"], [M_BAR] * n + [V_BAR] * n)


@pytest.mark.parametrize("world,key", MODEL_CASES)
def test_each_rank_holds_its_param_spec_part(runs, world, key):
    """Every leaf a rank holds has the shape of its ``param_spec`` part;
    the leaves held whole whose work runs on this rank's heads (rwkv's
    ``w0`` / ``ln_x``, Mamba2's ``A_log`` / ``D`` / ``dt_bias``) are
    whole and, after training, the same bits on every rank; and a step
    from ``init_cache(..., ctx=)`` gives this rank's logits."""
    outs = _outs(runs, world, key)
    case = dict((k, c) for _, k, c in CASE_KEYS)[key]
    _, mesh, model = case[:3]
    b = _batch(case)
    rows = b // mesh[0] if b % mesh[0] == 0 else b
    for r, o in enumerate(outs):
        assert all(o["spec_ok"]), (key, r, o["spec_ok"].index(False))
        assert o["init_cache_logits"] == (rows,
                                          _cfg(model).vocab_size), (key, r)
    if b != B:         # serving only: no train step to read
        return
    for name in SLICED.get(model, ()):
        idx = [i for i, p in enumerate(outs[0]["params_paths"])
               if p[-1] == name]
        assert idx, (key, name)
        for i in idx:
            assert outs[0]["params_parts"][i] == (), (key, name)
            for o in outs[1:]:
                assert np.array_equal(o["params"][i],
                                      outs[0]["params"][i]), (key, name)
