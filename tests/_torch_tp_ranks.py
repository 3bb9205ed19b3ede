"""Rank workers of tests/test_torch_tp.py, spawned by
``_torch_ep_ranks.spawn`` with this module's ``CASES``. Like that module
it imports neither jax nor the JAX package: the parent hands the inputs
over as numpy and checks what each rank saved.
"""
import numpy as np
import torch
import torch.distributed as dist

from _torch_ep_ranks import _ctx


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
    return {"tokens": torch.as_tensor(b[0]), "labels": torch.as_tensor(b[1])}


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
    optimizer state's leaves with their parts, and each parameter's
    held shape against the parts of ``param_spec`` (the train steps only
    where ``spec["train"]``)."""
    from repro_torch.launch.serve import generate, init_params
    from repro_torch.launch.sharding import (cache_spec, param_paths,
                                             param_spec, spec_parts,
                                             tree_parts)
    from repro_torch.models.common import parts_shape
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import leaves
    ctx = _ctx(spec["mesh"])
    cfg = _cfg(spec)
    model = build_model(cfg)
    out = {}
    params = init_params(model, seed=spec["seed"], device="cpu", ctx=ctx)
    stats = {}
    toks = generate(model, params, {"tokens": torch.as_tensor(
        spec["prompt"])}, steps=spec["steps"], ctx=ctx, stats=stats)
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
    del params
    if not spec["train"]:
        return out
    state, out["loss"], out["grad_norm"] = _train(model, ctx, spec)
    out["params"] = [_np(a) for a in leaves(state.params)]
    out["params_parts"] = _parts(tree_parts(state.params, cfg, ctx))
    out["opt"] = [_np(a) for a in leaves(state.opt)]
    out["opt_parts"] = _parts(tree_parts(state.opt, cfg, ctx,
                                         shapes=shapes))
    if spec.get("single") and dist.get_rank() == 0:
        local, loss, norm = _train(model, None, spec)
        out["single"] = {"loss": loss, "grad_norm": norm,
                         "params": [_np(a) for a in leaves(local.params)]}
    return out


def case_pinned(spec):
    """A family whose layout is not ported (rwkv, hybrid) under the mesh
    and on one device from one draw: every leaf whole, and the losses,
    grad norms and parameters of both runs."""
    from repro_torch.utils.tree import leaves
    ctx = _ctx(spec["mesh"])
    cfg = _cfg(spec)
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    out = {}
    for run, c in (("mesh", ctx), ("single", None)):
        state, loss, norm = _train(model, c, spec)
        out[run] = {"loss": loss, "grad_norm": norm,
                    "params": [_np(a) for a in leaves(state.params)]}
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


CASES = {"models": case_model, "pinned": case_pinned,
         "collectives": case_collectives, "refusal": case_refusal}
