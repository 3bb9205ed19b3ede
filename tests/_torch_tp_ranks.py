"""Rank workers of tests/test_torch_tp.py and tests/test_torch_tp_
families.py, spawned by ``_torch_ep_ranks.spawn`` with this module's
``CASES``, and the parent's side: :func:`run` starts the JAX process
(``_torch_tp_jax.py``) and the worlds side by side, and
:func:`check_parts` holds what each rank saved against JAX's global
arrays. Like ``_torch_ep_ranks`` it imports neither jax nor the JAX
package: the parent hands the inputs over as numpy (a batch, or a
prompt, is a dict of arrays: ``tokens``, ``labels`` for training, and
the family's ``enc_embeds`` or ``patch_embeds``).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_ep_ranks as R
from _torch_ep_ranks import _ctx

HERE = os.path.dirname(os.path.abspath(__file__))


def _np(t) -> np.ndarray:
    return t.detach().numpy()


def _cfg(spec):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    over = dict(spec["over"])
    if "moe" in over:
        over["moe"] = MoEConfig(**over["moe"])
    return get_config(spec["name"], reduced=True).replace(**over)


def _parts(parts_list):
    """Parts as plain tuples (axis, lo, hi), one a cut dim."""
    return [tuple((p.axis, p.lo, p.hi) for p in ps) for ps in parts_list]


def _batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _train(model, ctx, spec):
    """``spec``'s train steps from the seed's draw (this rank's parts
    under a mesh): (state, losses, grad norms)."""
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.optim import build_optimizer
    name, kw = spec["optimizer"]
    opt = build_optimizer(name, **kw)
    state = init_state(model, torch.Generator().manual_seed(spec["seed"]),
                       opt, ctx=ctx)
    step = make_train_step(model, ctx, opt)
    losses, norms = [], []
    for b in spec["batches"]:
        state, met = step(state, _batch(b))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return state, losses, norms


def case_model(spec):
    """A reduced model under the mesh: ``generate`` from the seed's draw
    (cut as drawn) over the prompt, its tokens, logits and final cache
    (this rank's part, with the leaves' parts of ``launch/sharding.
    cache_spec``); then the train steps, the parameters' and the
    optimizer state's leaves with their parts and paths, each
    parameter's held shape against the parts of ``param_spec`` (the
    train steps only where ``spec["train"]``), and the shape of the
    logits of a step from this rank's zeroed ``init_cache``."""
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.sharding import (cache_spec, cut_batch,
                                             param_paths, param_spec,
                                             spec_parts, tree_parts)
    from repro_torch.models.common import parts_shape
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    ctx = _ctx(spec["mesh"])
    cfg = _cfg(spec)
    model = build_model(cfg)
    out = {}
    params = init_params(model, seed=spec["seed"], device="cpu", ctx=ctx)
    stats = {}
    toks = generate(model, params, _batch(spec["prompt"]),
                    steps=spec["steps"], ctx=ctx, stats=stats)
    out["tokens"] = _np(toks)
    out["logits"] = np.stack([_np(lg) for lg in stats["logits"]])
    cache = stats["cache"]
    out["cache"] = [_np(a) for a in leaves(cache)]
    whole = spec["cache_shapes"]
    out["cache_parts"] = _parts([spec_parts(cache_spec(ctx, path, whole[i]),
                                            whole[i], ctx)
                                 for i, path in enumerate(param_paths(
                                     cache))])
    shapes = model.param_shapes()
    out["spec_ok"] = [
        tuple(a.shape) == parts_shape(spec_parts(param_spec(
            cfg, ctx, path, shapes[path]), shapes[path], ctx), shapes[path])
        for path, a in zip(param_paths(params), leaves(params))]
    B, S = spec["prompt"]["tokens"].shape
    c, first = cut_batch(ctx, {"tokens": torch.zeros((B,), dtype=torch.int32)})
    with torch.no_grad():
        lg, _ = model.serve_step(params, model.init_cache(B, S, ctx=ctx),
                                 first["tokens"], c)
    out["init_cache_logits"] = tuple(lg.shape)
    del params
    if not spec["train"]:
        return out
    state, out["loss"], out["grad_norm"] = _train(model, ctx, spec)
    out["params"] = [_np(a) for a in leaves(state.params)]
    out["params_parts"] = _parts(tree_parts(state.params, cfg, ctx))
    out["params_paths"] = param_paths(state.params)
    out["opt"] = [_np(a) for a in leaves(state.opt)]
    out["opt_parts"] = _parts(tree_parts(state.opt, cfg, ctx,
                                         shapes=shapes))
    if spec.get("single") and dist.get_rank() == 0:
        local, loss, norm = _train(model, None, spec)
        out["single"] = {"loss": loss, "grad_norm": norm,
                         "params": [_np(a) for a in leaves(local.params)]}
    return out


def case_collectives(spec):
    """``ShardGroup.reduce_scatter`` over each group of the mesh: this
    rank's output and its input's gradient at this rank's cotangent
    (rows of the JAX side's global arrays)."""
    ctx = _ctx(spec["mesh"])
    out = {}
    for axes, sub in spec["groups"].items():
        g = ctx.mesh.group(axes)
        i, n = g.index, g.size
        rows = sub["x"].shape[0] // n
        x = torch.as_tensor(sub["x"][i * rows:(i + 1) * rows])
        x.requires_grad_(True)
        y = g.reduce_scatter(x)
        ct = torch.as_tensor(sub["ct"][i * (rows // n):(i + 1) * (rows // n)])
        (grad,) = torch.autograd.grad(y, x, ct)
        # dim 1: the same sum along the second dim
        y1 = g.reduce_scatter(x.detach().T.contiguous(), dim=1)
        out[axes] = {"index": i, "y": _np(y), "grad": _np(grad),
                     "y_dim1": _np(y1)}
    return out


def case_refusal(spec):
    """Whole dense leaves under a cutting mesh: the error names the
    leaf."""
    from repro_torch.launch.serve import init_params
    from repro_torch.models.model import build_model
    ctx = _ctx(spec["mesh"])
    model = build_model(_cfg(spec))
    params = init_params(model, seed=0, device="cpu")
    try:
        with torch.no_grad():
            model.prefill(params, {"tokens": torch.zeros(
                (2, 8), dtype=torch.int32)}, ctx)
    except ValueError as e:
        return str(e)
    return None


CASES = {"models": case_model, "collectives": case_collectives,
         "refusal": case_refusal}


def run(jax_in: dict, worlds: dict, tmp: str):
    """(each world's rank outputs by world size, the JAX side's output):
    ``jax_in`` pickled for ``_torch_tp_jax.py``, which runs in a process
    of its own while each world of ``worlds`` ({size: cases}) is spawned
    in turn."""
    src, dst = os.path.join(tmp, "jax_in.pkl"), os.path.join(tmp,
                                                            "jax_out.pkl")
    with open(src, "wb") as f:
        pickle.dump(jax_in, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    child = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_tp_jax.py"), src, dst],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = {}
    try:
        for world, cases in worlds.items():
            wdir = os.path.join(tmp, f"world{world}")
            os.mkdir(wdir)
            ranks[world] = R.spawn(world, wdir, cases, CASES)
    finally:
        _, err = child.communicate(timeout=1200)
    assert child.returncode == 0, err[-4000:]
    with open(dst, "rb") as f:
        return ranks, pickle.load(f)


def slice_of(a, parts):
    """``a`` cut to ``parts`` ((axis, lo, hi) a cut dim)."""
    idx = [slice(None)] * a.ndim
    for axis, lo, hi in parts:
        idx[axis] = slice(lo, hi)
    return a[tuple(idx)]


def rel(got, want):
    """The largest gap over the largest magnitude of ``want`` (a bool
    leaf, the cross cache's ``cvalid``, as 0 / 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)) / max(
        float(np.max(np.abs(want), initial=0.0)), 1e-30)


def check_parts(outs, key, field, want_leaves, bar=1e-5):
    """Each rank's part of every leaf (``field`` and its ``<field>_parts``
    of the rank outputs) against the same slice of the whole leaf,
    within ``bar`` (one for every leaf, or a list of one a leaf); ranks
    holding the same part the same bits."""
    n = len(want_leaves)
    assert all(len(o[field]) == n for o in outs), (key, field)
    bars = [bar] * n if isinstance(bar, float) else bar
    for i, want in enumerate(want_leaves):
        held = {}
        for r, o in enumerate(outs):
            parts = o[f"{field}_parts"][i]
            got = o[field][i]
            ref = slice_of(want, parts)
            assert got.shape == ref.shape, (key, field, i, got.shape,
                                            ref.shape)
            assert rel(got, ref) <= bars[i], (key, field, i, rel(got, ref))
            if parts in held:
                assert np.array_equal(held[parts], got), (
                    key, field, i, f"rank {r} differs from another rank "
                    f"holding the same part")
            held[parts] = got
