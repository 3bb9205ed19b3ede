"""The distribution context of a mesh and the layout of the MoE layers'
experts over it (counterpart of ``repro/launch/sharding.py``'s
``make_ctx`` and of the expert leaves of its ``param_specs``).

The port runs every rank on the whole batch (replicated activations) and
cuts only the expert stacks: a leaf ``segments[i]["moe"][w1 | w3 | w2]``
holds this rank's :func:`repro_torch.models.moe.expert_part`, the
experts over the ``alltoall`` path's axes (padded to a multiple of the
shards) or, for ``impl="dense"``, every expert's FFN hidden dim over
``model``. Every other leaf stays whole on every rank. The reference's
FSDP, tensor-parallel and sequence-sharded layouts of the dense layers
(its ``_RULES``) are GSPMD layouts with the same results, not ported.
An optimizer state follows its parameter's cut (:func:`opt_spec`, the
reference's ``opt_specs``), and ``param_shards`` tells the clip and the
optimizer which leaves are parts (``launch/train.make_train_step``).

    mesh = make_mesh((2, 2), ("data", "model"), backend="nccl")
    ctx = make_ctx(mesh)
    params = init_params(model, seed=0, ctx=ctx)       # drawn, then cut
    params = convert.model_params(np_tree, cfg=cfg, ctx=ctx)  # or cut
    tokens = generate(model, params, batch, steps=32, ctx=ctx)
    step = make_train_step(model, ctx, optimizer)       # or train
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.models.common import DistCtx, Part
from repro_torch.models.moe import EXPERT_LEAVES, expert_part
from repro_torch.optim.optimizers import Shard


def make_ctx(mesh) -> DistCtx:
    """The context of a ``utils.mesh.Mesh``: ``model`` is the tensor /
    expert-parallel axis, every other axis a data-parallel one."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    return DistCtx(mesh=mesh, dp=dp, tp="model")


def expert_spec(cfg, ctx: DistCtx, name: str,
                ndim: int) -> Tuple[Optional[Tuple[str, ...]], ...]:
    """The mesh axes each dim of expert leaf ``name`` (``ndim`` dims: a
    layer's 3, a layer-stacked segment's 4) is cut over, None for a dim
    that is whole: the ``PartitionSpec`` entries of the reference's
    ``param_specs`` for the leaf, without FSDP."""
    spec = [None] * ndim
    part = expert_part(cfg.moe, ctx, name)
    if part is not None:
        spec[part.axis] = part.axes
    return tuple(spec)


def opt_spec(cfg, ctx: DistCtx, name: str, key: str,
             ndim: int) -> Tuple[Optional[Tuple[str, ...]], ...]:
    """:func:`expert_spec` for the optimizer state ``key`` of expert leaf
    ``name`` (``ndim`` dims), as the reference's ``opt_specs`` derives
    it: adamw's ``m`` / ``v`` and adafactor's ``v`` as the parameter,
    adafactor's ``r`` without the last dim, ``c`` without the second to
    last."""
    spec = expert_spec(cfg, ctx, name, ndim)
    if key == "r":
        return spec[:-1]
    if key == "c":
        return spec[:-2] + spec[-1:]
    return spec


def state_part(part: Optional[Part], key: str) -> Optional[Part]:
    """The part of optimizer state ``key`` of a leaf held as ``part``:
    adafactor's ``r`` (the leaf without its last dim) and ``c`` (without
    its second to last) are cut on the same dim when they keep it, and
    whole when they drop it; every other state as the leaf."""
    if part is None or key not in ("r", "c"):
        return part
    dropped = -1 if key == "r" else -2
    if part.axis == dropped:
        return None
    if part.axis < dropped:
        return dataclasses.replace(part, axis=part.axis + 1)
    return part


def _expert_leaf(path) -> Optional[Tuple[str, str]]:
    """(expert leaf name, state key) of a leaf at ``path`` (its dict keys
    from the root) that lies under an MoE layer's expert leaf: the key
    is adafactor's ``r`` / ``c`` below the leaf, else ``"m"`` (the
    parameter's own layout); None elsewhere."""
    for i in range(len(path) - 1):
        if path[i] == "moe" and path[i + 1] in EXPERT_LEAVES:
            below = path[i + 2:]
            return path[i + 1], (below[0] if below else "m")
    return None


def shard_params(tree, cfg, ctx: DistCtx):
    """``tree`` (a model's parameters, or an optimizer state over them:
    nested dicts and tuples of numpy arrays or tensors, each MoE layer's
    leaves whole) with every MoE layer's expert leaves, and their
    optimizer states, cut to this rank's part (:func:`state_part`); the
    other leaves are the same objects. Without a mesh the tree
    itself."""
    if ctx is None or ctx.mesh is None or cfg.moe is None:
        return tree

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, path) for v in t)
        leaf = _expert_leaf(path)
        if leaf is None:
            return t
        part = state_part(expert_part(cfg.moe, ctx, leaf[0]), leaf[1])
        return t if part is None else part.take(t)
    return walk(tree, ())


def param_shards(params, cfg, ctx: DistCtx) -> List[Optional[Shard]]:
    """Each leaf's :class:`optim.optimizers.Shard` in ``utils.tree.
    leaves`` order: an expert leaf held as a part over more than one
    rank, else None (every leaf without a mesh)."""
    out: List[Optional[Shard]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v, path)
        else:
            out.append(_leaf_shard(path))

    def _leaf_shard(path):
        leaf = _expert_leaf(path)
        if leaf is None or ctx is None or ctx.mesh is None:
            return None
        part = expert_part(cfg.moe, ctx, leaf[0])
        if part is None or ctx.mesh.size(part.axes) == 1:
            return None
        whole = cfg.moe.n_experts if part.axis == -3 else cfg.moe.d_expert
        return Shard(part.axis, part.lo, part.hi, whole,
                     ctx.mesh.group(part.axes))
    walk(params, ())
    return out
