"""Rank workers of tests/test_torch_ep_train.py, spawned by
``_torch_ep_ranks.spawn`` with this module's ``CASES``. Like that module
it imports neither jax nor the JAX package: the parent hands over the
inputs as numpy, and the ``restore`` cases read the JAX side's output
file (numpy trees) once it is written.
"""
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from _torch_ep_ranks import _ctx, _recording


def _np(t) -> np.ndarray:
    return t.detach().numpy()


def case_collectives(spec):
    """Every differentiable collective of ``ShardGroup`` over each group
    of the mesh: this rank's output and the input's gradient at this
    rank's cotangent (the JAX side's ops, cut to this rank)."""
    ctx = _ctx(spec["mesh"])
    out = {}
    for axes, sub in spec["groups"].items():
        g = ctx.mesh.group(axes)
        i, n = g.index, g.size

        def block(a, rows):
            return torch.as_tensor(a[i * rows:(i + 1) * rows])
        r = 2 * n
        x = block(sub["x"], r).requires_grad_(True)
        rep = torch.as_tensor(sub["rep"]).requires_grad_(True)
        ct = sub["ct"]
        ops = {
            "psum": (lambda: g.psum(x), x, torch.as_tensor(ct["psum"])),
            "all_gather": (lambda: g.all_gather(x), x,
                           torch.as_tensor(ct["all_gather"])),
            "all_gather_rs": (lambda: g.all_gather(x, grad="reduce_scatter"),
                              x, block(ct["all_gather_rs"], r * n)),
            "all_to_all": (lambda: g.all_to_all(x), x,
                           block(ct["all_to_all"], r)),
            "psum_grad": (lambda: g.psum_grad(rep) * (1.0 + i), rep,
                          block(ct["psum_grad"], r)),
            "shard_rows": (lambda: g.shard_rows(rep), rep,
                           block(ct["shard_rows"], 2)),
        }
        got = {}
        for name, (fn, inp, cot) in ops.items():
            y = fn()
            (grad,) = torch.autograd.grad(y, inp, cot)
            got[name] = (_np(y), _np(grad))
        out[axes] = {"ops": got, "index": i}
    return out


def _model(spec):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.model import build_model
    cfg = get_config(spec["name"], reduced=True).replace(
        dtype="float32", microbatch=spec["microbatch"])
    if spec["moe"] is not None:
        cfg = cfg.replace(moe=MoEConfig(**spec["moe"]))
    return cfg, build_model(cfg)


def _batch(b):
    return {"tokens": torch.as_tensor(b[0]), "labels": torch.as_tensor(b[1])}


def _run(model, ctx, opt, state, batches):
    """The steps of ``make_train_step`` over ``batches``: (state, losses,
    grad norms, the MoE paths taken)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import moe
    step = make_train_step(model, ctx, opt)
    seen, undo = _recording(moe)
    losses, norms = [], []
    try:
        for b in batches:
            state, met = step(state, _batch(b))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    finally:
        undo()
    return state, losses, norms, sorted(set(seen))


def _params_out(params, cfg, ctx):
    """The parameters' leaves (numpy) and each leaf's part (axis, lo, hi),
    None for a whole leaf (these configs cut a leaf on one dim at
    most: no FSDP)."""
    from repro_torch.launch.sharding import param_shards
    from repro_torch.utils.tree import leaves
    shards = param_shards(params, cfg, ctx)
    assert all(sh is None or len(sh.cuts) == 1 for sh in shards)
    parts = [None if sh is None else (sh.cuts[0].axis, sh.cuts[0].lo,
                                      sh.cuts[0].hi) for sh in shards]
    return [_np(a) for a in leaves(params)], parts


def case_train(spec):
    """A reduced model trained under the mesh: drawn with
    ``init_state(..., ctx=)`` (expert parts cut as drawn), 3 steps of
    ``make_train_step``; with ``grads`` the gradient at the first batch
    before them, with ``single`` (rank 0) the same steps on one device
    from the whole draw."""
    from repro_torch.launch.train import _value_and_grad, init_state
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    ctx = _ctx(spec["mesh"])
    cfg, model = _model(spec)
    name, kw = spec["optimizer"]
    opt = build_optimizer(name, **kw)
    state = init_state(model, torch.Generator().manual_seed(spec["seed"]),
                       opt, ctx=ctx)
    out = {}
    if spec["grads"]:
        _, _, grads = _value_and_grad(model, ctx, state.params,
                                      _batch(spec["batches"][0]))
        out["grads"] = [_np(g) for g in leaves(grads)]
    t0 = time.perf_counter()
    state, out["loss"], out["grad_norm"], out["paths"] = _run(
        model, ctx, opt, state, spec["batches"])
    out["seconds"] = time.perf_counter() - t0
    out["params"], out["parts"] = _params_out(state.params, cfg, ctx)
    if spec["single"] and dist.get_rank() == 0:
        local = init_state(model, torch.Generator().manual_seed(spec["seed"]),
                           opt)
        local, loss, norm, _ = _run(model, None, opt, local, spec["batches"])
        out["single"] = {"loss": loss, "grad_norm": norm,
                         "params": [_np(a) for a in leaves(local.params)]}
    return out


def case_dense(spec):
    """A dense-family model (no expert leaf) under the mesh and on one
    device from one draw: the parameters (this rank's parts under the
    mesh) and metrics of each."""
    from repro_torch.launch.train import init_state
    from repro_torch.optim import build_optimizer
    from repro_torch.utils.tree import leaves
    ctx = _ctx(spec["mesh"])
    cfg, model = _model(spec)
    name, kw = spec["optimizer"]
    out = {}
    for run, c in (("mesh", ctx), ("single", None)):
        opt = build_optimizer(name, **kw)
        state = init_state(model, torch.Generator().manual_seed(
            spec["seed"]), opt, ctx=c)
        state, loss, norm, _ = _run(model, c, opt, state, spec["batches"])
        out[run] = {"loss": loss, "grad_norm": norm}
        out[run]["params"], out[run]["parts"] = _params_out(state.params,
                                                            cfg, c)
    return out


def _wait_for(path: str, timeout: float = 900.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} was not written in {timeout} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        out = pickle.load(f)
    if "error" in out:
        raise RuntimeError(f"the JAX side failed:\n{out['error']}")
    return out


def case_restore(spec):
    """The JAX side's sharded-run state after ``spec["after"]`` steps
    (read from its output file) restored under the mesh with
    ``convert.train_state(..., cfg=, ctx=)``, then the next step: its
    metrics and parameters."""
    from repro_torch import convert
    from repro_torch.optim import build_optimizer
    ctx = _ctx(spec["mesh"])
    cfg, model = _model(spec)
    jax_out = _wait_for(spec["jax_out"])["train"][spec["of"]]
    state = convert.train_state(jax_out["states"][spec["after"]], "cpu",
                                cfg=cfg, ctx=ctx)
    name, kw = spec["optimizer"]
    state, loss, norm, _ = _run(model, ctx, build_optimizer(name, **kw),
                                state, spec["batches"])
    out = {"loss": loss, "grad_norm": norm, "step": int(state.step)}
    out["params"], out["parts"] = _params_out(state.params, cfg, ctx)
    return out


CASES = {"collectives": case_collectives, "train": case_train,
         "dense": case_dense, "restore": case_restore}
