"""Shared helpers of tests/test_torch_rwkv.py, tests/test_torch_hybrid.py,
tests/test_torch_encdec.py and tests/test_torch_vlm.py: a reduced model
(RWKV-6, Zamba2, Whisper or InternVL2) in both packages from one set of
JAX parameters, its family's inputs (``Pair.extra``: Whisper's frame
embeddings, InternVL2's patch embeddings) and the comparisons the files
make.

Tolerances (the largest |difference| over the largest |reference|):
- f32: 1e-5 for every function, logit, state and cache leaf, loss and
  gradient leaf; generated tokens exactly.
- The encdec and vlm files pass their own tolerances (1e-5 f32, 2e-2
  bf16; tests/test_torch_model.py's for the dense family).
- bf16: 1e-2 for one function alone (2.5 units in the last place of
  bf16, 2^-8 = 3.9e-3: XLA computes a fused chain of bf16 elementwise
  ops in f32 and rounds once, the port rounds after each op, as the
  reference is written); 5e-2 for the logits, states and caches of the
  whole model (those per-op differences carried through every layer,
  and for Zamba2 the shared block); the loss within 1e-3 relative. A
  bf16 gradient leaf is held to the f32 gradient at the same parameter
  values, not to JAX's bf16 gradient: JAX's own bf16 gradients lie 1-4%
  (in norm) from the f32 ones and the port's 2-6%, so two bf16
  computations that round differently cannot agree to
  tests/test_torch_train.py's 2e-2 of the norm. The port rounds after
  every op, XLA once per fused chain, so the port's leaf may be farther
  from the f32 gradient than JAX's: at most twice as far.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jax_config
from repro.launch.serve import make_prefill as jax_make_prefill
from repro.launch.serve import make_serve_step as jax_make_step
from repro.models.common import DistCtx as JaxCtx
from repro.models.model import build_model as jax_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.utils import tree

FN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def to_jax(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def to_torch(x, dtype):
    return torch.as_tensor(np.asarray(x, np.float32)).to(DTYPES[dtype])


class Pair:
    """A reduced config in both packages from one set of JAX parameters
    (``convert.model_params``); ``kw`` replaces config fields in both."""

    def __init__(self, name, dtype="float32", **kw):
        self.jcfg = jax_config(name, reduced=True).replace(dtype=dtype, **kw)
        self.cfg = get_config(name, reduced=True).replace(dtype=dtype, **kw)
        self.dtype = dtype
        self.jm, self.m = jax_build(self.jcfg), build_model(self.cfg)
        self.jp = jax.jit(self.jm.init)(jax.random.PRNGKey(0))
        self.p = convert.model_params(as_np(self.jp), "cpu")

    def tokens(self, B, S, seed):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, size=(B, S))
        labels = rng.integers(0, self.cfg.vocab_size, size=(B, S))
        labels[:, ::5] = -1
        return toks.astype(np.int32), labels.astype(np.int32)

    def extra(self, B, seed):
        """The family's inputs beside the tokens, f32 numpy drawn from
        ``seed``, x 0.02 as the JAX package's ``dummy_inputs``: the encdec
        family's ``enc_embeds`` (B, n_ctx, d), the vlm family's
        ``patch_embeds`` (B, n_prefix, d); none for the others."""
        rng = np.random.default_rng(1000 + seed)
        cfg = self.cfg
        if cfg.family == "encdec":
            return {"enc_embeds": (rng.normal(size=(
                B, cfg.encoder.n_ctx, cfg.d_model)) * 0.02).astype(
                    np.float32)}
        if cfg.family == "vlm":
            return {"patch_embeds": (rng.normal(size=(
                B, cfg.encoder.n_prefix, cfg.d_model)) * 0.02).astype(
                    np.float32)}
        return {}

    def jax_fns(self, room):
        self.jm.decode_room = room
        return (jax.jit(jax_make_prefill(self.jm, JaxCtx.local())),
                jax.jit(jax_make_step(self.jm, JaxCtx.local())))


_VALUE_AND_GRAD = {}


def jax_value_and_grad(jcfg):
    """The jitted ``jax.value_and_grad`` of the JAX model's loss, one per
    config (the bf16 test's f32 reference reuses the f32 test's)."""
    if jcfg not in _VALUE_AND_GRAD:
        jm = jax_build(jcfg)
        _VALUE_AND_GRAD[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, batch: jm.loss(p, batch, JaxCtx.local()),
            has_aux=True))
    return _VALUE_AND_GRAD[jcfg]


def jax_batch(toks, labels, extra=None):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
            **{k: jnp.asarray(v) for k, v in (extra or {}).items()}}


def torch_batch(toks, labels, extra=None):
    return {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels),
            **{k: torch.as_tensor(v) for k, v in (extra or {}).items()}}


def assert_tree_close(got, want, tol, what=""):
    """Every leaf of the port's tree (dicts in sorted-key order, as
    ``jax.tree_util`` takes them) against the JAX tree's: the same key
    paths, shapes and dtypes, values within ``tol`` of the leaf's
    largest magnitude (bit for bit at 0; not compared at None)."""
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(want)]
    gl, wl = tree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) == len(paths), (what, len(gl), len(wl))
    for path, g, w in zip(paths, gl, wl):
        assert tuple(g.shape) == tuple(w.shape), (what, path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (what, path)
        if tol is None:
            continue
        if tol == 0.0:
            np.testing.assert_array_equal(f32(g), f32(w), err_msg=what + path)
        else:
            assert max_rel(g, w) <= tol, (what, path, max_rel(g, w))


def check_prefill_and_decode(pr, S, steps=4, tol=None):
    """Prefill of 2 prompts of S tokens (with the family's inputs), then
    ``steps`` decode steps: logits after each, and every cache leaf (the
    states, the shared block's caches, the encoder's keys and values)
    after the prefill and after the last step, within ``tol`` (default
    ``TOL``)."""
    jprefill, jstep = pr.jax_fns(steps + 1)
    pr.m.decode_room = steps + 1
    toks, _ = pr.tokens(2, S, seed=S)
    extra = pr.extra(2, seed=S)
    tol = TOL[pr.dtype] if tol is None else tol
    jl, jc = jprefill(pr.jp, {"tokens": jnp.asarray(toks),
                              **{k: jnp.asarray(v) for k, v in extra.items()}})
    tl, tc = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks), **{
        k: torch.as_tensor(v) for k, v in extra.items()}})
    assert max_rel(tl, jl) <= tol
    assert_tree_close(tc, jc, tol, "prefill cache")
    held = tree.leaves({k: v for k, v in tc.items() if k != "len"})
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jstep(pr.jp, jc, jnp.asarray(tok))
        tl, tc = pr.m.serve_step(pr.p, tc, torch.as_tensor(tok))
        assert max_rel(tl, jl) <= tol
    assert_tree_close(tc, jc, tol, "decode cache")
    # Updated in place: the prefill's tensors ("len" aside, which each
    # step returns anew).
    now = tree.leaves({k: v for k, v in tc.items() if k != "len"})
    assert len(now) == len(held) and all(a is b for a, b in zip(now, held))


def check_decode_equals_fresh_prefill(pr, S):
    """One decode step after a prefill of S tokens equals a fresh
    prefill of the S + 1 tokens (the family's inputs the same) within
    1e-5 (f32)."""
    toks, _ = pr.tokens(2, S + 1, seed=3)
    extra = {k: torch.as_tensor(v) for k, v in pr.extra(2, seed=3).items()}
    pr.m.decode_room = 2
    _, cache = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks[:, :S]),
                                   **extra})
    got, _ = pr.m.serve_step(pr.p, cache, torch.as_tensor(toks[:, S]))
    want, _ = pr.m.prefill(pr.p, {"tokens": torch.as_tensor(toks), **extra})
    assert max_rel(got, want) <= 1e-5


def check_init_cache(pr):
    for B, S in ((3, 16), (1, 40)):
        assert_tree_close(pr.m.init_cache(B, S), pr.jm.init_cache(B, S), 0.0,
                          "init_cache")


def check_loss_and_grads(pr, toks, labels, want_leaf, extra=None):
    """loss, ce, aux and every gradient leaf against jax.value_and_grad,
    with the family's inputs ``extra``; ``want_leaf`` names a key path
    (or a tuple of them) that must be among the gradients. In bf16 the
    gradients are held to the f32 model's (JAX) at the same parameter
    values."""
    from repro_torch.launch.train import _value_and_grad

    batch = jax_batch(toks, labels, extra)
    (jl, jmet), jg = jax_value_and_grad(pr.jcfg)(pr.jp, batch)
    if pr.dtype == "bfloat16":
        _, exact = jax_value_and_grad(pr.jcfg.replace(dtype="float32"))(
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), pr.jp),
            batch)
        exact = jax.tree_util.tree_leaves(exact)
    loss, met, g = _value_and_grad(pr.m, None, pr.p,
                                   torch_batch(toks, labels, extra))
    assert sorted(met) == sorted(jmet) == ["aux", "ce"]
    ltol = 1e-5 if pr.dtype == "float32" else 1e-3
    for got, want in ((loss, jl), (met["ce"], jmet["ce"])):
        assert abs(float(got) - float(want)) <= ltol * abs(float(want)), (
            float(got), float(want))
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(jg)]
    assert len(paths) == len(tree.leaves(g))
    for want in (want_leaf,) if isinstance(want_leaf, str) else want_leaf:
        assert any(want in p for p in paths), f"no gradient of {want}"
    for i, (path, got, want) in enumerate(zip(
            paths, tree.leaves(g), jax.tree_util.tree_leaves(jg))):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        assert float(np.max(np.abs(f32(want)))) > 0, path
        if pr.dtype == "float32":
            assert max_rel(got, want) <= 1e-5, (
                f"gradient of {path}", max_rel(got, want))
        else:
            ref = f32(exact[i])
            assert np.linalg.norm(f32(got) - ref) <= 2.0 * np.linalg.norm(
                f32(want) - ref), path
    return g


def check_train_steps(pr, mb, lr=1e-3, **kw):
    """At microbatch ``mb`` (and the config fields ``kw``, in both
    packages), 3 steps of the jitted JAX train_step with adamw (eps
    1e-4, as tests/test_torch_train.py) and of the port's, from one JAX
    TrainState carried by convert.train_state, on batches of 4 x 32
    tokens with the family's inputs: loss and grad norm within 1e-5
    relative and every parameter within 1e-5 of its leaf's largest
    magnitude + 1e-6 after each step; the moments within 1e-4 after the
    last."""
    import repro.optim as joptim
    from repro.launch.train import TrainState as JaxTrainState
    from repro.launch.train import make_train_step as jax_train_step
    from repro_torch import optim
    from repro_torch.launch.train import make_train_step
    jopt = joptim.build_optimizer("adamw", lr, eps=1e-4)
    opt = optim.build_optimizer("adamw", lr, eps=1e-4)
    jstate = JaxTrainState(pr.jp, jopt.init(pr.jp), jnp.zeros((), jnp.int32))
    state = convert.train_state(as_np(jstate), "cpu")
    assert_tree_close(state.params, jstate.params, 0.0, "train_state params")
    assert_tree_close(state.opt, jstate.opt, 0.0, "train_state opt")
    jstep = jax.jit(jax_train_step(
        jax_build(pr.jcfg.replace(microbatch=mb, **kw)), JaxCtx.local(),
        jopt))
    step = make_train_step(build_model(pr.cfg.replace(microbatch=mb, **kw)),
                           None, opt)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jstate.params)]
    for i in range(3):
        toks, labels = pr.tokens(4, 32, seed=10 + i)
        extra = pr.extra(4, seed=10 + i)
        jstate, jmet = jstep(jstate, jax_batch(toks, labels, extra))
        state, met = step(state, torch_batch(toks, labels, extra))
        assert int(state.step) == i + 1
        assert sorted(met) == sorted(jmet)
        for key in ("loss", "grad_norm"):
            assert abs(float(met[key]) - float(jmet[key])) <= 1e-5 * abs(
                float(jmet[key])), (i, key)
        for path, got, want in zip(paths, tree.leaves(state.params),
                                   jax.tree_util.tree_leaves(jstate.params)):
            err = np.max(np.abs(f32(got) - f32(want)))
            assert err <= 1e-5 * np.max(np.abs(f32(want))) + 1e-6, (i, path)
    for got, want in zip(tree.leaves(state.opt),
                         jax.tree_util.tree_leaves(jstate.opt)):
        assert max_rel(got, want) <= 1e-4


def check_convert_round_trip(pr):
    """convert.model_params carries every leaf one to one (key paths,
    shapes, dtypes and bits), the f32 leaves of a bf16 model included,
    and convert.train_state adamw's moments and the step."""
    import repro.optim as joptim
    from repro.launch.train import TrainState as JaxTrainState
    assert_tree_close(pr.p, pr.jp, 0.0, "model_params")
    # The port's own init has the JAX package's tree: its constant leaves
    # (interpolation vectors, decays, norms, A_log / D / dt_bias) the same
    # values, its drawn leaves the same scale (std within 10%).
    own = pr.m.init(torch.Generator().manual_seed(0))
    assert_tree_close(own, pr.jp, None, "init")
    for g, w in zip(tree.leaves(own), jax.tree_util.tree_leaves(pr.jp)):
        g, w = f32(g), f32(w)
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w)
        else:
            assert abs(g.std() / w.std() - 1.0) < 0.1, (g.std(), w.std())
    jopt = joptim.build_optimizer("adamw", 1e-3)
    jp = pr.jp
    js = jopt.init(jp)
    grads = jax.tree_util.tree_map(
        lambda a: (jnp.ones(a.shape, jnp.float32) * 1e-2).astype(a.dtype), jp)
    jp, js = jax.jit(jopt.update)(grads, js, jp, jnp.int32(0))
    state = convert.train_state(as_np(JaxTrainState(jp, js, jnp.int32(1))),
                                "cpu")
    assert int(state.step) == 1
    assert_tree_close(state.params, jp, 0.0, "train_state params")
    assert_tree_close(state.opt, js, 0.0, "train_state opt")
    return state
