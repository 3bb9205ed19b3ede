"""The JAX package's side of tests/test_torch_ep_train.py, run as a script
in a process of its own, which forces 8 host devices before it imports
jax (as tests/_torch_ep_jax.py does):

    python tests/_torch_ep_train_jax.py <cases.pkl> <out.pkl>

``cases.pkl`` (written by the test) holds:

* ``train``: reduced model cases (config name, MoEConfig fields,
  microbatch, mesh shape, optimizer, the parameters' leaves in
  ``jax.tree_util`` order, the batches). Each runs the reference's
  ``make_train_step`` jitted with the shardings ``launch/dryrun.py``
  gives it (``param_specs``, ``opt_specs``, ``batch_specs``) over the
  batches, and records each step's loss and grad norm, the state after
  each step (``keep``: the steps whose whole state is kept, as numpy
  trees) and the MoE paths traced (``_dense_shard_map``,
  ``_alltoall_local`` or ``_local_moe``). With ``grads`` it also records
  the jitted sharded gradient of the loss at the first batch.
* ``collectives``: for each mesh and each group of its axes, the inputs
  and cotangents of the ``shard_map`` ops whose transposes the port's
  differentiable collectives mirror; records each op's output and
  ``jax.vjp`` (one jitted program a mesh).
"""
import os
import pickle
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# A third less compile work (the XLA passes that only speed the steps
# up), which the parallel suite's other workers share the cores with.
jax.config.update("jax_disable_most_optimizations", True)
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import optim  # noqa: E402
from repro.configs.base import MoEConfig, get_config  # noqa: E402
from repro.launch.sharding import (batch_specs, make_ctx,  # noqa: E402
                                   opt_specs, param_specs, to_shardings)
from repro.launch.train import TrainState, make_train_step  # noqa: E402
from repro.models import moe as MoE  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.utils.compat import shard_map  # noqa: E402

NAMES = ("data", "model")
THREADS = 4


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), NAMES)


# The paths traced, by thread: the cases run in a few threads at once
# (XLA compiles and runs without the interpreter lock).
TRACED = threading.local()


def _recorded(name, fn):
    def wrapped(*args, **kw):
        TRACED.paths.append(name)
        return fn(*args, **kw)
    return wrapped


MoE._dense_shard_map = _recorded("etp", MoE._dense_shard_map)
MoE._alltoall_local = _recorded("alltoall", MoE._alltoall_local)
MoE._local_moe = _recorded("local", MoE._local_moe)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def train_case(case):
    """3 (or more) steps of the jitted sharded train step."""
    cfg = get_config(case["name"], reduced=True).replace(
        dtype="float32", microbatch=case["microbatch"],
        moe=MoEConfig(**case["moe"]))
    model = build_model(cfg)
    treedef = jax.tree_util.tree_structure(
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in case["leaves"]])
    name, kw = case["optimizer"]
    opt = optim.build_optimizer(name, **kw)
    mesh = mesh_of(case["mesh"])
    ctx = make_ctx(mesh)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    pspecs = param_specs(params, cfg, mesh, ctx.dp)
    state_sh = TrainState(to_shardings(pspecs, mesh),
                          to_shardings(opt_specs(state.opt, pspecs), mesh),
                          NamedSharding(mesh, P()))
    batches = [{"tokens": jnp.asarray(t), "labels": jnp.asarray(lb)}
               for t, lb in case["batches"]]
    bsh = to_shardings(batch_specs(batches[0], mesh, ctx.dp), mesh)
    TRACED.paths = []
    out = {"loss": [], "grad_norm": [], "states": {}}
    with mesh:
        step = jax.jit(make_train_step(model, ctx, opt),
                       in_shardings=(state_sh, bsh),
                       out_shardings=(state_sh, None))
        if case.get("grads"):
            grad = jax.jit(jax.grad(lambda p, b: model.loss(p, b, ctx)[0]),
                           in_shardings=(state_sh.params, bsh))
            out["grads"] = as_np(grad(params, batches[0]))
        for i, batch in enumerate(batches):
            state, met = step(state, batch)
            out["loss"].append(float(met["loss"]))
            out["grad_norm"].append(float(met["grad_norm"]))
            if i + 1 in case["keep"]:
                out["states"][i + 1] = as_np(
                    (state.params, state.opt, state.step))
    out["paths"] = sorted(set(TRACED.paths))
    return out


def _collective_ops(mesh, ax, n):
    """The ``shard_map`` ops over the mesh axes ``ax`` (the other axes
    replicated), by name: (function, its input's name)."""
    def sm(f, i, o):
        return shard_map(f, mesh=mesh, in_specs=i, out_specs=o)
    vary = P(ax)

    def rows(v):
        b = v.shape[0] // n
        return jax.lax.dynamic_slice_in_dim(v, jax.lax.axis_index(ax) * b, b,
                                            0)
    return {
        # psum into a replicated output (Megatron's g)
        "psum": (sm(lambda v: jax.lax.psum(v, ax), vary, P()), "x"),
        # all_gather into a replicated output: this shard's rows back
        "all_gather": (sm(lambda v: jax.lax.all_gather(
            v, ax, axis=0, tiled=True), vary, P()), "x"),
        # all_gather into shard-local work: a reduce-scatter back
        "all_gather_rs": (sm(lambda v: jax.lax.all_gather(
            v, ax, axis=0, tiled=True), vary, vary), "x"),
        "all_to_all": (sm(lambda v: jax.lax.all_to_all(
            v, ax, 0, 0, tiled=True), vary, vary), "x"),
        # a replicated input entering shard-local work (Megatron's f)
        "psum_grad": (sm(lambda v: v * (1.0 + jax.lax.axis_index(ax)),
                         P(), vary), "rep"),
        # this shard's rows of a replicated input
        "shard_rows": (sm(rows, P(), vary), "rep"),
    }


def collective_case(specs):
    """Every op over each group of one mesh (``specs``: by axes, with
    the mesh shape, the number of shards ``n``, the inputs ``x`` (sharded
    over the axes, shard order) and ``rep`` (replicated) and each op's
    cotangent ``ct[op]``), as one jitted program: each op's output (a
    global array) and its input's gradient from ``jax.vjp``."""
    mesh = mesh_of(next(iter(specs.values()))["mesh"])
    ops = {axes: _collective_ops(mesh, axes, spec["n"])
           for axes, spec in specs.items()}

    # Each op its own copy of its input, so that each gradient is its own.
    def run(ins):
        return {axes: {name: fn(ins[axes][name])
                       for name, (fn, _) in by.items()}
                for axes, by in ops.items()}
    ins = {axes: {name: jnp.asarray(specs[axes][arg])
                  for name, (_, arg) in by.items()}
           for axes, by in ops.items()}
    cts = {axes: {name: jnp.asarray(s["ct"][name]) for name in ops[axes]}
           for axes, s in specs.items()}
    with mesh:
        ys, vjp = jax.vjp(jax.jit(run), ins)
        (grads,) = vjp(cts)
    return {axes: {name: (np.asarray(ys[axes][name]),
                          np.asarray(grads[axes][name])) for name in by}
            for axes, by in ops.items()}


def main(src, dst):
    with open(src, "rb") as f:
        cases = pickle.load(f)
    failed = None
    try:
        with ThreadPoolExecutor(THREADS) as pool:
            train = {k: pool.submit(train_case, c)
                     for k, c in cases["train"].items()}
            colls = {k: pool.submit(collective_case, c)
                     for k, c in cases["collectives"].items()}
            out = {"train": {k: f.result() for k, f in train.items()},
                   "collectives": {k: f.result()
                                   for k, f in colls.items()}}
    except Exception as e:    # the rank workers wait for this file
        import traceback
        failed, out = e, {"error": traceback.format_exc()}
    # Written whole, then renamed, so that no reader sees a part of it.
    with open(dst + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(dst + ".part", dst)
    if failed is not None:
        raise failed


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
