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

    mesh = make_mesh((2, 2), ("data", "model"), backend="nccl")
    ctx = make_ctx(mesh)
    params = init_params(model, seed=0, ctx=ctx)       # drawn, then cut
    params = convert.model_params(np_tree, cfg=cfg, ctx=ctx)  # or cut
    tokens = generate(model, params, batch, steps=32, ctx=ctx)
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.models.common import DistCtx
from repro_torch.models.moe import EXPERT_LEAVES, expert_part


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


def shard_params(tree, cfg, ctx: DistCtx):
    """``tree`` (a model's parameters: nested dicts and tuples of numpy
    arrays or tensors, each MoE layer's leaves whole) with every MoE
    layer's expert leaves cut to this rank's part; the other leaves are
    the same objects. Without a mesh the tree itself."""
    if ctx is None or ctx.mesh is None or cfg.moe is None:
        return tree

    def cut(name, leaf):
        part = expert_part(cfg.moe, ctx, name)
        return leaf if part is None else part.take(leaf)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: (cut(k, v) if key == "moe" and k in EXPERT_LEAVES
                        else walk(v, k)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return t
    return walk(tree)
