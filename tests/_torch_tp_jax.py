"""The JAX package's side of tests/test_torch_tp.py, run as a script in a
process of its own, which forces 8 host devices before it imports jax
(as tests/_torch_ep_train_jax.py does):

    python tests/_torch_tp_jax.py <cases.pkl> <out.pkl>

``cases.pkl`` (written by the test) holds:

* ``models``: reduced model cases (config name and overrides, mesh
  shape, optimizer, the parameters' leaves in ``jax.tree_util`` order,
  the train batches and the serving prompt, each a dict of arrays (the
  tokens, and the family's ``enc_embeds`` or ``patch_embeds``), and the
  decode steps). Each runs
  the reference's prefill and its greedy ``serve_step`` s (one program
  for the prefill, one for a step), and ``make_train_step`` (unless
  ``train`` is False), jitted with the
  shardings ``launch/dryrun.py`` gives them (``param_specs``,
  ``batch_specs``, ``cache_specs_tree`` for the cache it returns,
  ``opt_specs``), and records the prefill's and every decode step's
  logits, the greedy tokens, the cache after the last step, each train step's loss and grad norm, and the state after the
  last step.
* ``collectives``: for each mesh and each group of its axes, the input
  and cotangent of ``psum_scatter`` (tiled, dim 0) in a ``shard_map``;
  records its output and ``jax.vjp`` (one jitted program a mesh).
"""
import os
import pickle
import sys
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
from repro.launch.sharding import (batch_specs,  # noqa: E402
                                   cache_specs_tree, make_ctx, opt_specs,
                                   param_specs, to_shardings)
from repro.launch.train import TrainState, make_train_step  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.utils.compat import shard_map  # noqa: E402

NAMES = ("data", "model")
THREADS = 4


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), NAMES)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def config(case):
    over = dict(case["over"])
    if "moe" in over:
        over["moe"] = MoEConfig(**over["moe"])
    return get_config(case["name"], reduced=True).replace(**over)


def model_case(case):
    """The jitted sharded prefill + greedy decode, then the train
    steps."""
    cfg = config(case)
    model = build_model(cfg)
    treedef = jax.tree_util.tree_structure(
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in case["leaves"]])
    mesh = mesh_of(case["mesh"])
    ctx = make_ctx(mesh)
    pspecs = param_specs(params, cfg, mesh, ctx.dp)
    psh = to_shardings(pspecs, mesh)
    out = {}
    with mesh:
        # serving: the prefill, then greedy decode steps, as one program
        steps = case["steps"]
        model.decode_room = steps + 1
        batch = {k: jnp.asarray(v) for k, v in case["prompt"].items()}
        bsh = to_shardings(batch_specs(batch, mesh, ctx.dp), mesh)

        def prefill(p, b):
            return model.prefill(p, b, ctx)

        def step(p, c, tok):
            return model.serve_step(p, c, tok, ctx)
        cache_shape = jax.eval_shape(prefill, params, batch)[1]
        csh = to_shardings(cache_specs_tree(cache_shape, mesh, ctx.dp), mesh)
        logits, cache = jax.jit(prefill, in_shardings=(psh, bsh),
                                out_shardings=(None, csh))(params, batch)
        # one program a decode step, compiled once
        step = jax.jit(step, in_shardings=(psh, csh, None),
                       out_shardings=(None, csh))
        seen, toks = [logits], []
        for _ in range(steps):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(tok)
            logits, cache = step(params, cache, tok)
            seen.append(logits)
        out["logits"] = np.stack([np.asarray(lg) for lg in seen])
        out["tokens"] = np.stack([np.asarray(t) for t in toks], axis=1)
        out["cache"] = as_np(cache)
        if not case["train"]:
            return out

        # training
        name, kw = case["optimizer"]
        opt = optim.build_optimizer(name, **kw)
        state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
        state_sh = TrainState(psh,
                              to_shardings(opt_specs(state.opt, pspecs),
                                           mesh),
                              NamedSharding(mesh, P()))
        batches = [{k: jnp.asarray(v) for k, v in b.items()}
                   for b in case["batches"]]
        bsh = to_shardings(batch_specs(batches[0], mesh, ctx.dp), mesh)
        train = jax.jit(make_train_step(model, ctx, opt),
                        in_shardings=(state_sh, bsh),
                        out_shardings=(state_sh, None))
        out["loss"], out["grad_norm"] = [], []
        for b in batches:
            state, met = train(state, b)
            out["loss"].append(float(met["loss"]))
            out["grad_norm"].append(float(met["grad_norm"]))
        out["params"] = [np.asarray(a) for a in
                         jax.tree_util.tree_leaves(state.params)]
        out["opt"] = [np.asarray(a) for a in
                      jax.tree_util.tree_leaves(state.opt)]
    return out


def collective_case(specs):
    """``psum_scatter`` (tiled, dim 0) over each group of one mesh
    (``specs``: by axes, with the mesh shape, the input ``x`` (each
    shard's block of it, stacked in shard order) and the cotangent
    ``ct``), as one jitted program: its output (a global array) and the
    input's gradient from ``jax.vjp``."""
    mesh = mesh_of(next(iter(specs.values()))["mesh"])

    def op(ax):
        return shard_map(lambda v: jax.lax.psum_scatter(
            v, ax, scatter_dimension=0, tiled=True), mesh=mesh,
            in_specs=P(ax), out_specs=P(ax))

    ops = {axes: op(axes) for axes in specs}

    def run(ins):
        return {axes: ops[axes](ins[axes]) for axes in ops}
    ins = {axes: jnp.asarray(s["x"]) for axes, s in specs.items()}
    cts = {axes: jnp.asarray(s["ct"]) for axes, s in specs.items()}
    with mesh:
        ys, vjp = jax.vjp(jax.jit(run), ins)
        (grads,) = vjp(cts)
    return {axes: (np.asarray(ys[axes]), np.asarray(grads[axes]))
            for axes in specs}


def main(src, dst):
    with open(src, "rb") as f:
        cases = pickle.load(f)
    failed = None
    try:
        with ThreadPoolExecutor(THREADS) as pool:
            models = {k: pool.submit(model_case, c)
                      for k, c in cases["models"].items()}
            colls = {k: pool.submit(collective_case, c)
                     for k, c in cases["collectives"].items()}
            out = {"models": {k: f.result() for k, f in models.items()},
                   "collectives": {k: f.result()
                                   for k, f in colls.items()}}
    except Exception as e:    # the parent waits for this file
        import traceback
        failed, out = e, {"error": traceback.format_exc()}
    with open(dst + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(dst + ".part", dst)
    if failed is not None:
        raise failed


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
