"""The distribution context of a mesh and the layout of every leaf over
it (counterpart of ``repro/launch/sharding.py``: its ``make_ctx``,
``param_specs``, ``batch_specs``, ``cache_specs_tree`` and
``opt_specs``).

The reference gives each leaf a ``PartitionSpec`` and leaves the
collectives to GSPMD; the port holds each leaf as that spec cuts it and
writes the collectives out (``models/``, through
``models/common.relay`` and ``utils/mesh.ShardGroup``). The rules, as
the reference's ``_RULES`` and ``_resolve`` state them:

  * "tp" puts a weight's heads, FFN hidden dim or vocab on ``model``;
    "fsdp" puts its other dim on the ``dp`` axes when ``cfg.fsdp``;
  * a dim that does not divide its axes' size stays whole (``_resolve``
    tests the flat dim: at tp=4 reduced Mixtral's ``wk`` of 2 kv heads
    of 32 is cut into 16 columns, inside a head; the attention then
    gathers it and replicates the kv heads, as Megatron does for fewer
    kv heads than ranks);
  * a layer-stacked leaf's leading layer dim is never cut;
  * the MoE layers' expert leaves as ``models/moe.expert_part`` cuts
    them (the experts over the ``alltoall`` path's axes, padded to a
    multiple of the shards where E does not divide, or the FFN hidden
    dim over ``model``), plus the template's FSDP dim (:func:`expert_spec`);
  * the batch on the ``dp`` axes where it divides (:func:`batch_spec`),
    else whole on every rank; the decode cache's batch likewise and its
    kv heads on ``model`` where they divide (:func:`cache_spec`); where
    the batch does not divide (the reference's ``long_500k`` shape, B =
    1), the cache's keys, values and latents are cut on the sequence
    over ``dp`` instead (its context-parallel cache, :func:`seq_block`):
    each rank attends over its block of the keys and the ranks' partial
    softmax states are merged (``models/attention.py``);
  * an optimizer state as its parameter, adafactor's ``r`` without the
    last dim's cut and ``c`` without the second to last's
    (:func:`opt_spec`).

Every family is held so: dense and moe; ssm (RWKV-6's ``tm`` / ``cm``
leaves, its state ``s`` on heads); hybrid (Zamba2's FSDP-only ``mix``
projections, its shared attention block, the Mamba2 state ``h`` on
heads); encdec (Whisper's encoder stack and ``xattn``, the cross cache
``ck`` / ``cv`` on kv heads); vlm (InternVL2's ``vis_proj``).

    mesh = make_mesh((2, 2), ("data", "model"), backend="nccl")
    ctx = make_ctx(mesh)
    params = init_params(model, seed=0, ctx=ctx)       # drawn, then cut
    params = convert.model_params(np_tree, cfg=cfg, ctx=ctx)  # or cut
    tokens = generate(model, params, batch, steps=32, ctx=ctx)
    step = make_train_step(model, ctx, optimizer)       # or train
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.models.common import (DistCtx, Part, parts_shape, relay,
                                       take_parts)
from repro_torch.optim.optimizers import Cut, Shard
from repro_torch.utils.tree import leaves

TP = "tp"
FSDP = "fsdp"

# (path-suffix match) -> per-dim template over the leaf's LAST dims: the
# reference's _RULES.
_RULES = [
    (("attn", "wq"), (FSDP, TP)), (("attn", "wk"), (FSDP, TP)),
    (("attn", "wv"), (FSDP, TP)), (("attn", "wo"), (TP, FSDP)),
    (("attn", "bq"), (TP,)), (("attn", "bk"), (TP,)), (("attn", "bv"), (TP,)),
    (("xattn", "wq"), (FSDP, TP)), (("xattn", "wk"), (FSDP, TP)),
    (("xattn", "wv"), (FSDP, TP)), (("xattn", "wo"), (TP, FSDP)),
    (("attn", "wq_a"), (FSDP, None)), (("attn", "wq_b"), (None, TP)),
    (("attn", "wkv_a"), (FSDP, None)), (("attn", "wk_b"), (None, TP)),
    (("attn", "wv_b"), (None, TP)),
    (("ffn", "w1"), (FSDP, TP)), (("ffn", "w3"), (FSDP, TP)),
    (("ffn", "w2"), (TP, FSDP)), (("ffn", "b1"), (TP,)),
    (("moe", "router"), (FSDP, None)),
    (("shared", "w1"), (FSDP, TP)), (("shared", "w3"), (FSDP, TP)),
    (("shared", "w2"), (TP, FSDP)),
    (("tm", "wr"), (FSDP, TP)), (("tm", "wk"), (FSDP, TP)),
    (("tm", "wv"), (FSDP, TP)), (("tm", "wg"), (FSDP, TP)),
    (("tm", "wo"), (TP, FSDP)), (("tm", "wA"), (FSDP, None)),
    (("tm", "wB"), (None, TP)), (("tm", "u"), (TP, None)),
    (("cm", "wk"), (FSDP, TP)), (("cm", "wv"), (TP, FSDP)),
    (("mix", "in_proj"), (FSDP, None)), (("mix", "out_proj"), (None, FSDP)),
    # embed: vocab on model only (the reference's note: an FSDP cut of d
    # makes its token gather unpartitionable).
    (("embed",), (TP, None)),
    (("unembed",), (FSDP, TP)),
    (("vis_proj",), (FSDP, TP)),
    (("mtp_proj",), (FSDP, TP)),
]

EXPERT_LEAVES = ("w1", "w3", "w2")

Spec = Tuple[Optional[Tuple[str, ...]], ...]


def make_ctx(mesh) -> DistCtx:
    """The context of a ``utils.mesh.Mesh``: ``model`` is the tensor /
    expert-parallel axis, every other axis a data-parallel one."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    return DistCtx(mesh=mesh, dp=dp, tp="model")


def _mesh_size(ctx: DistCtx, axes) -> int:
    n = 1
    for a in axes:
        n *= ctx.mesh.shape[a]
    return n


def _resolve(template, shape, ctx: DistCtx, use_fsdp: bool) -> Spec:
    """The reference's ``_resolve``: a template over the leaf's last
    dims -> the mesh axes of each dim (None: whole), a dim that does not
    divide falling back to whole, the leading (layer) dims whole; at
    most one dim on ``model`` and one on the ``dp`` axes."""
    extra = len(shape) - len(template)
    spec: List[Optional[Tuple[str, ...]]] = [None] * extra
    used_model = used_dp = False
    dp = tuple(ctx.dp)
    for t, n in zip(template, shape[extra:]):
        if t == TP and not used_model and n % ctx.mesh.shape[ctx.tp] == 0:
            spec.append((ctx.tp,))
            used_model = True
        elif (t == FSDP and use_fsdp and not used_dp
              and n % _mesh_size(ctx, dp) == 0):
            spec.append(dp)
            used_dp = True
        else:
            spec.append(None)
    return tuple(spec)


def _moe_expert_template(cfg, name: str):
    if cfg.moe and cfg.moe.impl == "alltoall":
        return (TP, FSDP, None)          # experts on model, d on fsdp
    if name in ("w1", "w3"):
        return (None, FSDP, TP)          # (E, d, ff): ff on model
    return (None, TP, FSDP)              # (E, ff, d)


def _fsdp_expert_dim(cfg, ctx: DistCtx, name: str,
                     shape) -> Optional[int]:
    """The dim (negative) of expert leaf ``name`` that the template cuts
    over the ``dp`` axes under ``cfg.fsdp``, where it divides; None on
    the ``alltoall`` path's ``ep="2d"`` layout (the reference's 2-D
    branch holds no FSDP dim) and without FSDP."""
    m = cfg.moe
    if not getattr(cfg, "fsdp", False) or (m.impl == "alltoall"
                                           and m.ep == "2d"):
        return None
    tpl = _moe_expert_template(cfg, name)
    axis = tpl.index(FSDP) - 3
    return axis if shape[axis] % _mesh_size(ctx, ctx.dp) == 0 else None


def expert_spec(cfg, ctx: DistCtx, name: str, ndim: int,
                shape: Optional[Sequence[int]] = None) -> Spec:
    """The mesh axes each dim of expert leaf ``name`` (``ndim`` dims: a
    layer's 3, a layer-stacked segment's 4) is cut over, None for a dim
    that is whole: the reference's ``param_specs`` for the leaf, where
    E divides the experts' axes (where it does not, the reference holds
    the stack whole and pads it in its ``apply_moe``; the port holds the
    padded part it runs on). ``shape`` (the whole leaf's) is needed
    only under ``cfg.fsdp``."""
    from repro_torch.models.moe import expert_part
    spec: List[Optional[Tuple[str, ...]]] = [None] * ndim
    part = expert_part(cfg.moe, ctx, name)
    if part is not None:
        spec[part.axis] = part.axes
    if shape is not None:
        axis = _fsdp_expert_dim(cfg, ctx, name, shape)
        if axis is not None:
            spec[axis] = tuple(ctx.dp)
    return tuple(spec)


def _is_expert(names: Tuple[str, ...]) -> bool:
    """An MoE layer's expert stack (``moe.w1`` / ``w3`` / ``w2``)."""
    return (len(names) >= 2 and names[-2] == "moe"
            and names[-1] in EXPERT_LEAVES)


def _expert_branch(cfg, ctx: DistCtx, name: str, shape) -> Spec:
    """The reference's ``param_specs`` for a leaf it takes for an expert
    leaf (any ``w1`` / ``w2`` / ``w3`` below ``moe``), from the leaf's
    shape: on the 2-D ``alltoall`` layout its dim -3 over the largest
    minor-first axis prefix whose size divides it, else the template."""
    m = cfg.moe
    shape = tuple(shape)
    if m and m.impl == "alltoall" and m.ep == "2d":
        E = shape[len(shape) - 3]
        axes = [ctx.tp]
        nsh = ctx.mesh.shape[ctx.tp]
        for a in reversed(tuple(ctx.dp)):
            sz = ctx.mesh.shape[a]
            if nsh * sz <= E and E % (nsh * sz) == 0:
                axes.append(a)
                nsh *= sz
            else:
                break
        if E % nsh == 0:
            return ((None,) * (len(shape) - 3)
                    + (tuple(reversed(axes)), None, None))
    return _resolve(_moe_expert_template(cfg, name), shape, ctx,
                    bool(getattr(cfg, "fsdp", False)))


def param_spec(cfg, ctx: DistCtx, path: Sequence[str],
               shape: Sequence[int]) -> Spec:
    """The reference's ``PartitionSpec`` of the leaf at ``path`` (its
    dict keys from the root; a tuple's index as a string) of shape
    ``shape`` (the whole, layer-stacked leaf's), as the mesh axes of
    each dim (None: whole), for any family. Like the reference it takes
    any ``w1`` / ``w2`` / ``w3`` below ``moe`` for an expert leaf: the
    shared experts' stacks included, whose layer dim the ``alltoall``
    templates then cut (the port holds them by the ``shared`` rule:
    :func:`held_spec`)."""
    names = tuple(str(n) for n in path)
    shape = tuple(shape)
    if "moe" in names and names[-1] in EXPERT_LEAVES:
        return _expert_branch(cfg, ctx, names[-1], shape)
    return _rule_spec(cfg, ctx, names, shape)


def _rule_spec(cfg, ctx: DistCtx, names, shape) -> Spec:
    for suffix, tpl in _RULES:
        if names[-len(suffix):] == suffix:
            return _resolve(tpl, shape, ctx, bool(getattr(cfg, "fsdp",
                                                          False)))
    return (None,) * len(shape)


def held_spec(cfg, ctx: DistCtx, path: Sequence[str],
              shape: Sequence[int]) -> Spec:
    """How the port holds the leaf at ``path`` (whole shape ``shape``):
    :func:`param_spec`, but for two cases. An MoE layer's expert stack
    as :func:`expert_spec` (the reference's spec where E divides its
    axes; where it does not, the padded part the port runs on, for
    :func:`held_shape`'s extent); the shared experts of an MoE layer by
    their own ``shared`` rule, (FSDP, TP) on (d, ff) and (TP, FSDP) on
    (ff, d), where the reference's expert branch takes them."""
    names = tuple(str(n) for n in path)
    shape = tuple(shape)
    if _is_expert(names):
        return expert_spec(cfg, ctx, names[-1], len(shape), shape)
    if "moe" in names and names[-1] in EXPERT_LEAVES:     # shared experts
        return _rule_spec(cfg, ctx, names, shape)
    return param_spec(cfg, ctx, names, shape)


def held_shape(cfg, ctx: DistCtx, path: Sequence[str],
               shape: Sequence[int]) -> Tuple[int, ...]:
    """The extent of each dim of the leaf as the port holds it: its whole
    ``shape``, but an expert stack's experts padded to a multiple of
    their shards as ``models/moe.expert_part`` pads them."""
    shape = tuple(shape)
    names = tuple(str(n) for n in path)
    if ctx is None or ctx.mesh is None or not _is_expert(names):
        return shape
    from repro_torch.models.moe import expert_part
    part = expert_part(cfg.moe, ctx, names[-1])
    if part is None:
        return shape
    out = list(shape)
    out[part.axis] = (part.hi - part.lo) * _mesh_size(ctx, part.axes)
    return tuple(out)


def spec_parts(spec: Spec, shape: Sequence[int],
               ctx: DistCtx) -> Tuple[Part, ...]:
    """This rank's :class:`Part` of each dim that ``spec`` cuts over
    more than one rank (axes counted from the last)."""
    out = []
    nd = len(shape)
    for i, axes in enumerate(spec):
        if axes is None or _mesh_size(ctx, axes) == 1:
            continue
        n = shape[i] // _mesh_size(ctx, axes)
        s = ctx.mesh.index(axes)
        out.append(Part(i - nd, s * n, (s + 1) * n, tuple(axes)))
    return tuple(out)


def leaf_parts(cfg, ctx: Optional[DistCtx], path: Sequence[str],
               shape: Sequence[int]) -> Tuple[Part, ...]:
    """This rank's parts of the leaf at ``path`` whose whole shape is
    ``shape``, as the port holds it (:func:`held_spec` over
    :func:`held_shape`): one :class:`Part` a cut dim; () for a whole leaf
    or without a mesh."""
    if ctx is None or ctx.mesh is None:
        return ()
    shape = held_shape(cfg, ctx, path, shape)
    return spec_parts(held_spec(cfg, ctx, path, shape), shape, ctx)


def use(w, cfg, ctx: Optional[DistCtx], path: Sequence[str],
        shape: Sequence[int], *, keep_tp: bool = False,
        tp_partial: bool = False):
    """Leaf ``w`` (held as :func:`leaf_parts` of the leaf at ``path``,
    whole shape ``shape``) as the work uses it: its cut over ``tp`` kept
    where ``keep_tp`` (the work is this rank's heads, hidden columns or
    vocab rows), every other cut gathered (FSDP's over the ``dp`` axes);
    ``tp_partial``: the work differs over ``tp`` (tensor-parallel, or on
    this rank's rows of a sequence-cut residual). The backward sums the
    leaf's cotangent over the axes where the work differs
    (``DistCtx.partial_axes``: ``dp`` where the batch is cut),
    reduce-scattering a gathered cut's (``models/common.relay``). A leaf
    held otherwise than its parts (a whole leaf under a cutting mesh) is
    refused by name. Without a mesh ``w`` itself."""
    if ctx is None or ctx.mesh is None:
        return w
    parts = leaf_parts(cfg, ctx, path, shape)
    want = parts_shape(parts, shape)
    if tuple(w.shape) != want:
        raise ValueError(
            f"leaf {'.'.join(map(str, path))} has shape {tuple(w.shape)}, "
            f"but under the mesh {dict(ctx.mesh.shape)} this rank holds "
            f"{want} of the whole {tuple(shape)}; draw the parameters with "
            f"init_params(..., ctx=ctx) or convert them with "
            f"convert.model_params(..., cfg=cfg, ctx=ctx)")
    need = tuple(p for p in parts if keep_tp and p.axes == (ctx.tp,))
    return relay(w, parts, need, ctx.mesh, ctx.partial_axes(tp_partial))


def batch_spec(ctx: DistCtx, shape: Sequence[int]) -> Spec:
    """The reference's ``batch_specs`` for one input leaf: the batch
    (leading) dim on the ``dp`` axes where it divides, else whole."""
    if len(shape) == 0:
        return ()
    dp = ctx.dp_size
    if shape[0] % dp == 0 and shape[0] > 0:
        return (tuple(ctx.dp),) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def cut_batch(ctx: Optional[DistCtx], batch):
    """(ctx, batch) for a step on the global ``batch`` (a dict of
    tensors, every rank the same: the tokens and labels, the encdec
    family's ``enc_embeds``, the vlm family's ``patch_embeds``): where
    the batch divides over more than one ``dp`` shard
    (:func:`batch_spec`), each leaf's rows of this rank and the context
    marked ``batch_cut``; else both as given."""
    if ctx is None or ctx.mesh is None:
        return ctx, batch
    B = next(iter(batch.values())).shape[0]
    if ctx.dp_size == 1 or batch_spec(ctx, (B,))[0] is None:
        return ctx, batch
    n = B // ctx.dp_size
    i = ctx.mesh.index(tuple(ctx.dp))
    return (dataclasses.replace(ctx, batch_cut=True),
            {k: v[i * n:(i + 1) * n] for k, v in batch.items()})


def cache_spec(ctx: DistCtx, path: Sequence[str],
               shape: Sequence[int]) -> Spec:
    """The reference's ``cache_specs_tree`` for one decode-cache leaf
    (keyed by its last name): the batch on the ``dp`` axes where it
    divides; where it does not, a key, value or latent leaf (``k``,
    ``v``, ``ck``, ``cv``, ``latent``, ``rope``: (L, B, S, ...)) cut on
    its sequence dim over ``dp`` where that divides (the context-parallel
    cache), the ring's ``pos``, the cross mask ``cvalid`` and the state
    leaves whole; kv heads (``k``, ``v``, ``ck``, ``cv``) and rwkv /
    mamba state heads (``s``, ``h``) on ``model`` where they divide."""
    dp, tp = ctx.dp_size, ctx.tp_size
    dpa = tuple(ctx.dp)
    key = str(tuple(path)[-1])
    shape = tuple(shape)
    if key == "len":
        return (dpa,) if shape[0] % dp == 0 else (None,)
    spec: List[Optional[Tuple[str, ...]]] = [None] * len(shape)
    if key in _SEQ_LEAVES + ("pos", "cvalid", "shift", "shift2", "conv",
                             "s", "h"):
        if shape[1] % dp == 0:
            spec[1] = dpa
        elif key in _SEQ_LEAVES and shape[2] % dp == 0:
            spec[2] = dpa
    if key in ("k", "v", "ck", "cv") and shape[3] % tp == 0:
        spec[3] = (ctx.tp,)
    if key in ("s", "h") and shape[2] % tp == 0:
        spec[2] = (ctx.tp,)
    return tuple(spec)


# The decode-cache leaves with a sequence dim (dim 2 of (L, B, S, ...)).
_SEQ_LEAVES = ("k", "v", "ck", "cv", "latent", "rope")


def seq_block(ctx: Optional[DistCtx], B: int,
              n: int) -> Optional[Tuple[int, int]]:
    """This rank's block [lo, hi) of the n positions of a decode-cache
    leaf's sequence dim where :func:`cache_spec` cuts it over ``dp``
    (the context-parallel cache: the blocks contiguous and equal, in
    shard order), B being the global batch. None where the leaf holds
    every position: no mesh, one ``dp`` shard, the batch cut over ``dp``
    (``ctx.batch_cut``: the leaf holds this rank's rows), or n not
    dividing."""
    if (ctx is None or ctx.mesh is None or ctx.dp_size == 1
            or ctx.batch_cut):
        return None
    if cache_spec(ctx, ("k",), (1, B, n, 1, 1))[2] is None:
        return None
    m = n // ctx.dp_size
    i = ctx.mesh.index(tuple(ctx.dp))
    return i * m, (i + 1) * m


def cut_cache_seq(cache, ctx: Optional[DistCtx]):
    """``cache`` (a decode cache whose sequence leaves are whole, their
    batch and kv heads already this rank's) with each key, value and
    latent leaf cut to this rank's :func:`seq_block` of its sequence;
    the cache itself where nothing is cut."""
    if ctx is None or ctx.mesh is None:
        return cache

    def cut(path, a):
        if str(path[-1]) not in _SEQ_LEAVES:
            return a
        block = seq_block(ctx, a.shape[1], a.shape[2])
        return a if block is None else a[:, :, block[0]:block[1]].clone()
    return _walk_leaves(cache, cut)


def shard_cache(cache, ctx: Optional[DistCtx]):
    """``cache`` (a decode cache, every leaf whole) with every leaf cut
    to this rank's part of :func:`cache_spec`; without a mesh the cache
    itself."""
    if ctx is None or ctx.mesh is None:
        return cache
    return _walk_leaves(cache, lambda path, a: take_parts(spec_parts(
        cache_spec(ctx, path, a.shape), a.shape, ctx), a))


def opt_spec(spec: Spec, key: str, ndim: Optional[int] = None) -> Spec:
    """The spec of optimizer state ``key`` (``ndim`` dims) of a leaf laid
    out as ``spec``, as the reference's ``opt_specs`` derives it: adamw's
    ``m`` / ``v``, sgd's ``m`` and adafactor's ``v`` as the parameter,
    adafactor's ``r`` without the last dim, ``c`` without the second to
    last; a state whose dims then do not match is whole. Over
    :func:`param_spec` the reference's, over :func:`held_spec` the
    port's (:func:`state_parts`)."""
    spec = tuple(spec)
    if key == "r":
        spec = spec[:-1]
    elif key == "c":
        spec = spec[:-2] + spec[-1:]
    ndim = len(spec) if ndim is None else ndim
    return spec if len(spec) == ndim else (None,) * ndim


def _state_shape(shape: Tuple[int, ...], key: str) -> Tuple[int, ...]:
    if key == "r":
        return shape[:-1]
    if key == "c":
        return shape[:-2] + shape[-1:]
    return shape


def state_parts(cfg, ctx: Optional[DistCtx], path: Sequence[str],
                shape: Sequence[int], key: str) -> Tuple[Part, ...]:
    """This rank's parts of optimizer state ``key`` of the leaf at
    ``path`` (whole shape ``shape``): :func:`opt_spec` over the leaf's
    :func:`held_spec`, cut as :func:`leaf_parts` cuts the leaf."""
    if ctx is None or ctx.mesh is None:
        return ()
    shape = held_shape(cfg, ctx, path, shape)
    sshape = _state_shape(shape, key)
    return spec_parts(opt_spec(held_spec(cfg, ctx, path, shape), key,
                               len(sshape)), sshape, ctx)


def _walk_leaves(tree, fn, path=()):
    """``tree`` with every array leaf ``a`` at ``path`` replaced by
    ``fn(path, a)`` (:func:`param_paths`' paths)."""
    if isinstance(tree, dict):
        return {k: _walk_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk_leaves(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_paths(tree) -> List[Tuple[str, ...]]:
    """Each leaf's path in ``utils.tree.leaves`` order (sorted keys): its
    dict keys from the root, a tuple's index as a string (the
    reference's ``_path_names``)."""
    out: List[Tuple[str, ...]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out.append(path)
    walk(tree, ())
    return out


def leaf_shapes(tree):
    """{path: shape} of every leaf of ``tree`` (:func:`param_paths`'
    paths)."""
    out = {}
    _walk_leaves(tree, lambda path, a: out.setdefault(path,
                                                      tuple(a.shape)))
    return out


def _is_state(tree) -> bool:
    """An optimizer state (adamw's {"m", "v"}, sgd's {"m"}, adafactor's
    {"f"}), not a parameter tree (whose top keys are the model's)."""
    return (isinstance(tree, dict) and bool(tree)
            and set(tree) <= {"m", "v", "f"})


def _leaf_of(tree, cfg, ctx: DistCtx, shapes):
    """The function (path, leaf) -> this rank's parts of the leaf at
    ``path`` of ``tree`` (a parameter tree, or an optimizer state over
    one: :func:`state_parts` of its parameter). ``shapes``: each
    parameter's whole shape (a parameter tree's own leaves' where None;
    the model's for a state)."""
    state = _is_state(tree)
    if state and shapes is None:
        shapes = model_shapes(cfg)

    def parts(path, a):
        key = "m"
        if state:
            if path[0] == "f":
                path, key = path[1:-1], path[-1]
            else:
                path = path[1:]
        shape = tuple(a.shape) if shapes is None else tuple(shapes[path])
        return state_parts(cfg, ctx, path, shape, key)
    return parts


def tree_parts(tree, cfg, ctx: DistCtx, *, shapes=None) -> List[tuple]:
    """Each leaf's parts (:func:`leaf_parts`, one :class:`Part` a cut
    dim; () for a whole leaf), in ``utils.tree.leaves`` order, of a
    parameter tree or an optimizer state over one as this rank holds it
    (``shapes``: each parameter's whole shape, the model's by
    default)."""
    paths = param_paths(tree)
    if ctx is None or ctx.mesh is None:
        return [()] * len(paths)
    parts = _leaf_of(tree, cfg, ctx, shapes or model_shapes(cfg))
    return [parts(p, a) for p, a in zip(paths, leaves(tree))]


def shard_params(tree, cfg, ctx: DistCtx, *, shapes=None):
    """``tree`` (a model's parameters, or an optimizer state over them:
    nested dicts and tuples of numpy arrays or tensors, every leaf
    whole) with every leaf cut to this rank's parts as the port holds it
    (:func:`leaf_parts`; an optimizer state's as :func:`state_parts`
    derives them); a leaf that is whole stays the same object.
    ``shapes`` maps each parameter's path to its whole shape: a
    parameter tree's own leaves' by default, the model's
    (``Model.param_shapes``) for a state. Without a mesh the tree
    itself."""
    if ctx is None or ctx.mesh is None:
        return tree
    parts = _leaf_of(tree, cfg, ctx, shapes)

    def cut(path, a):
        ps = parts(path, a)
        return take_parts(ps, a) if ps else a
    return _walk_leaves(tree, cut)


_SHAPES = {}


def model_shapes(cfg):
    """{path: whole shape} of every parameter of a model of ``cfg``
    (``models/model.Model.param_shapes``, kept a config)."""
    key = repr(cfg)
    if key not in _SHAPES:
        from repro_torch.models.model import Model
        _SHAPES[key] = Model(cfg).param_shapes()
    return _SHAPES[key]


def param_shards(params, cfg, ctx: DistCtx,
                 shapes=None) -> List[Optional[Shard]]:
    """Each leaf's :class:`optim.optimizers.Shard` in ``utils.tree.
    leaves`` order: a leaf held as parts over more than one rank, with
    each cut dim's :class:`optim.optimizers.Cut` and the group of every
    rank that holds a part of it; None for a whole leaf (every leaf
    without a mesh). ``shapes`` (each path's whole shape) defaults to
    the model's own (``models/model.Model.param_shapes``)."""
    paths = param_paths(params)
    if ctx is None or ctx.mesh is None:
        return [None] * len(paths)
    if shapes is None:
        shapes = model_shapes(cfg)
    out: List[Optional[Shard]] = []
    for path in paths:
        shape = shapes[path]
        parts = leaf_parts(cfg, ctx, path, shape)
        if not parts:
            out.append(None)
            continue
        cuts = tuple(Cut(p.axis, p.lo, p.hi, shape[p.axis],
                         ctx.mesh.group(p.axes)) for p in parts)
        axes = tuple(a for a in ctx.mesh.axis_names
                     if any(a in p.axes for p in parts))
        out.append(Shard(cuts, ctx.mesh.group(axes)))
    return out
