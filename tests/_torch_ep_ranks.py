"""Rank workers of tests/test_torch_ep.py.

``torch.multiprocessing.spawn`` pickles a worker by its qualified name,
so the workers live in this importable module, which imports neither
jax nor the JAX package: the parent test computes the JAX side and hands
the inputs and the parameters over as numpy arrays. Every rank joins
a gloo world through a FileStore, runs every case it is given in order
and saves what it computed to ``rank<r>.pt`` for the parent to check.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

NAMES = ("data", "model")


def spawn(world: int, tmp: str, cases: dict, handlers=None) -> list:
    """Run ``cases`` (``{kind: {key: spec}}``, each spec given to
    ``handlers[kind]``; this module's ``CASES`` by default) on every rank
    of a gloo world of ``world`` ranks; returns each rank's results, in
    rank order."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(world, tmp, cases, handlers or CASES),
             nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, cases: dict,
               handlers: dict) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {kind: {key: handlers[kind](spec)
                      for key, spec in specs.items()}
               for kind, specs in cases.items()}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _ctx(shape):
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.utils.mesh import make_mesh
    return make_ctx(make_mesh(shape, NAMES, backend="gloo"))


def a2a_block(rank: int, blocks: int, dtype) -> torch.Tensor:
    """What ``rank`` sends: ``blocks`` blocks of (2, 3), each entry
    naming the sender, the block and its place."""
    v = (torch.arange(blocks * 6, dtype=torch.float64).reshape(blocks * 2, 3)
         + 1000 * rank)
    if dtype == torch.bool:
        return (v.long() + rank) % 3 == 0
    return v.to(dtype)


def case_a2a(spec):
    """``ShardGroup.all_to_all`` over each group of the mesh, in f32,
    bf16 and bool, and over ("data", "model") again as the reference's
    ``_grid_a2a`` composes it: one exchange a mesh axis (minor first)
    on the (data, model, ...) grid of blocks."""
    ctx = _ctx(spec["mesh"])
    mesh, rank = ctx.mesh, dist.get_rank()
    out = {}
    for axes in spec["axes"]:
        g = mesh.group(axes)
        for dtype in (torch.float32, torch.bfloat16, torch.bool):
            x = a2a_block(rank, g.size, dtype)
            out[(axes, str(dtype))] = (g.ranks, g.all_to_all(x))
    sizes = tuple(mesh.shape[a] for a in NAMES)
    x = a2a_block(rank, mesh.size(NAMES), torch.float32)
    grid = x.reshape(*sizes, -1, 3)
    for k in reversed(range(len(NAMES))):
        moved = grid.movedim(k, 0)
        moved = mesh.group((NAMES[k],)).all_to_all(moved.contiguous())
        grid = moved.movedim(0, k)
    out["grid"] = (grid.reshape(x.shape),
                   mesh.group(NAMES).all_to_all(x))
    return out


PATH_FNS = {"etp": "_dense_shard_map", "alltoall": "_alltoall",
            "local": "_local_moe"}


def _recording(moe):
    """Wrap the paths of ``moe.apply_moe`` to record which ran; returns
    the record and a function that undoes the wrapping."""
    seen, saved = [], {}
    for name, fn in PATH_FNS.items():
        orig = getattr(moe, fn)
        saved[fn] = orig

        def wrapped(*a, _name=name, _orig=orig, **kw):
            seen.append(_name)
            return _orig(*a, **kw)
        setattr(moe, fn, wrapped)
    return seen, lambda: [setattr(moe, k, v) for k, v in saved.items()]


def case_layer(spec):
    """The sharded ``apply_moe`` on one layer case: this rank's output,
    aux loss, the path it took and the shapes of its expert parts."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.sharding import shard_params
    from repro_torch.models import moe
    ctx = _ctx(spec["mesh"])
    cfg = type("C", (), {"moe": MoEConfig(**spec["moe"])})()
    p = {k: torch.as_tensor(v) for k, v in shard_params(
        {"moe": spec["params"]}, cfg, ctx)["moe"].items()}
    seen, undo = _recording(moe)
    try:
        y, aux = moe.apply_moe(p, torch.as_tensor(spec["x"]), cfg, ctx)
    finally:
        undo()
    return {"y": y.numpy(), "aux": float(aux), "path": seen[0],
            "parts": {k: tuple(p[k].shape) for k in moe.EXPERT_LEAVES}}


def case_model(spec):
    """A reduced model under the mesh, its expert leaves cut from the
    whole parameters on the host (``convert.model_params``): the
    prefill's logits at the config's capacity factor, and ``generate``'s
    tokens and logits at a dropless one."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    ctx = _ctx(spec["mesh"])
    cfg = get_config(spec["name"], reduced=True).replace(
        dtype="float32", moe=MoEConfig(**spec["moe"]))
    params = convert.model_params(spec["params"], "cpu", cfg=cfg, ctx=ctx)
    model = build_model(cfg)
    tokens = torch.as_tensor(spec["tokens"])
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": tokens}, ctx)
    dropless = build_model(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=spec["dropless"])))
    stats = {}
    toks = generate(dropless, params, {"tokens": tokens},
                    steps=spec["steps"], ctx=ctx, stats=stats)
    return {"logits": logits.numpy(), "tokens": toks.numpy(),
            "step_logits": np.stack([lg.numpy() for lg in stats["logits"]]),
            "w1": tuple(params["segments"][-1]["moe"]["w1"].shape)}


CASES = {"a2a": case_a2a, "layers": case_layer, "models": case_model}
