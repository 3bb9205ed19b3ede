"""Named device meshes over ``torch.distributed`` (counterpart of
``repro/utils/compat.make_mesh`` and of the ``jax.lax`` collectives that
the JAX package's shard_map paths use).

JAX's ``shard_map`` has one controller; ``torch.distributed`` has one
process per rank, and every rank runs the same program on the same host
inputs. A :class:`Mesh` names the axes of the ranks (row-major, the
first axis the most major, as ``jax.make_mesh`` lays devices out) over a
``torch.distributed.device_mesh.DeviceMesh``; ``mesh.group(axes)`` is
the :class:`ShardGroup` of the ranks that share this rank's coordinates
on every other axis, in shard order: the flat index over ``axes``,
listed from major to minor, as a ``PartitionSpec((*axes,))`` sharding
and a tiled ``all_gather`` order them.

Every collective that reduces is built on one all-gather, so that a
replicated result is the same bits on every rank whatever the backend:
``psum`` is an all-gather followed by a sum in shard order
(``all_reduce(SUM)`` would add in the backend's own order, a ring's for
gloo and another for NCCL), and ``pmax`` / ``pmin`` take the maximum /
minimum of the gathered values. ``all_to_all`` (the expert-parallel MoE
dispatch) only moves blocks, so no order of additions is at stake: it
is one ``all_to_all_single`` of the blocks' bytes.

The backend is chosen by the caller and never switched:

  * ``nccl``: one rank per card, collectives on CUDA tensors;
  * ``gloo``: CPU tensors, or several ranks sharing one card, where a
    CUDA tensor is staged through the host (gloo has neither
    ``all_gather`` nor ``min``/``max`` on CUDA tensors).

Process groups are created when the mesh is made, by every rank in the
same order (``dist.new_group`` is collective), never lazily inside one
rank's branch.

Gradients follow the layout of the port's sharded work: every rank holds
the replicated values (the whole batch, the loss) and runs shard-local
work on its part between two collectives, as a ``shard_map`` body. The
differentiable collectives transpose as ``shard_map`` transposes the
``jax.lax`` ops:

  * ``psum`` of shard-local partials into a replicated result passes the
    (replicated) cotangent through to each partial (Megatron's g);
  * ``all_gather`` into a replicated result takes this shard's rows of
    the cotangent; with ``grad="reduce_scatter"`` (a gathered value
    feeding shard-local work, whose cotangents differ by rank) it sums
    the cotangents over the group, in shard order, and takes this
    shard's rows;
  * ``all_to_all``'s backward is the reverse exchange: the same tiled
    exchange of the cotangent;
  * ``reduce_scatter`` of shard-local partials into this shard's rows of
    their sum (the sequence-parallel residual after a tensor-parallel
    product) all-gathers the cotangent back (Megatron-SP's g-bar);
  * ``psum_grad`` marks a replicated value entering shard-local work:
    the identity forward, a psum of the cotangent backward (Megatron's
    f); ``shard_rows`` takes this shard's rows of a replicated value,
    and all-gathers the cotangent backward.

A group of one is a no-op both ways. ``all_gather_many``,
``all_gather(..., active=)``, ``pmax`` and ``pmin`` are forward-only (the
serve plane's and the server's): they refuse a tensor that requires a
gradient, by name, instead of dropping the gradient.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "Mesh", "MeshError", "ShardGroup", "make_mesh"]

BACKENDS = ("nccl", "gloo")


class MeshError(ValueError):
    """A mesh request failed validation; the message names the field."""


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class ShardGroup:
    """The ranks of one set of mesh axes that share this rank's other
    coordinates, in shard order, with the collectives over them.

    ``ranks`` are the members' global ranks in shard order; ``index`` is
    this rank's shard index. ``pg`` is the process group, or None for a
    group of one rank that no collective ever crosses."""

    def __init__(self, ranks: Sequence[int], pg, backend: str):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.pg = pg
        self.backend = backend
        # all_gather fills its list in process-group rank order; the
        # shard order may differ (axes listed minor before major).
        pg_ranks = (list(self.ranks) if pg is None
                    else dist.get_process_group_ranks(pg))
        self._order = [pg_ranks.index(r) for r in self.ranks]
        self._inverse = sorted(range(self.size), key=self._order.__getitem__)

    @property
    def transport(self) -> str:
        """How a CUDA tensor crosses ranks on this group's backend."""
        return ("CUDA tensors, NCCL" if self.backend == "nccl"
                else "CPU tensors, gloo (CUDA tensors staged through the "
                     "host)")

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (same shape and dtype on each), in shard
        order, on ``x``'s device."""
        if self.pg is None:
            return [x]
        dev = x.device
        t = x.contiguous()
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        if self.backend == "gloo":
            t = t.cpu()
        elif t.device.type != "cuda":
            raise MeshError(f"backend='nccl' gathers CUDA tensors; got a "
                            f"tensor on {t.device}")
        bufs = [torch.empty_like(t) for _ in range(len(self._order))]
        dist.all_gather(bufs, t, group=self.pg)
        out = [bufs[j] for j in self._order]
        if x.dtype == torch.bool:
            out = [b.view(torch.bool) for b in out]
        return [b.to(dev) for b in out]

    def all_gather(self, x: torch.Tensor, *, active: Optional[int] = None,
                   grad: str = "rows", dim: int = 0) -> torch.Tensor:
        """Tiled all-gather along dim ``dim`` (0 unless given), in shard
        order. With ``active`` only the first ``active`` shards hold
        rows: the others send a placeholder of the same shape, which is
        dropped (forward-only).

        The backward takes this shard's rows of the cotangent
        (``grad="rows"``: the gathered value is replicated, and so is its
        cotangent), or sums the cotangents over the group in shard order
        first (``grad="reduce_scatter"``: the gathered value feeds
        shard-local work)."""
        if active is not None:
            _forward_only("all_gather(..., active=)", x)
            return torch.cat(self._exchange(x)[:active], dim=0)
        if dim % x.dim():
            return self.all_gather(x.movedim(dim, 0), grad=grad).movedim(
                0, dim)
        if grad not in _GATHER_GRADS:
            raise MeshError(f"all_gather grad={grad!r} is invalid: accepted "
                            f"values are {list(_GATHER_GRADS)}")
        if self.pg is not None and _needs_grad(x):
            return _Gather.apply(x, self, grad == "reduce_scatter")
        return self._gather(x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._exchange(x), dim=0)

    def all_gather_many(self, tensors: Sequence[Optional[torch.Tensor]],
                        *, active: Optional[int] = None):
        """:meth:`all_gather` of several tensors with the same leading
        dim in one collective: their rows are packed as bytes side by
        side, gathered once and unpacked bit for bit. ``None`` entries
        pass through. Forward-only."""
        real = [t for t in tensors if t is not None]
        _forward_only("all_gather_many", *real)
        rows = real[0].shape[0]
        flat = [t.contiguous().reshape(rows, -1) for t in real]
        byte = [t.view(torch.uint8) for t in flat]
        packed = self.all_gather(torch.cat(byte, dim=1), active=active)
        out, col = [], 0
        for t, b in zip(real, byte):
            width = b.shape[1]
            # A fresh row-major copy: a one-row slice counts as
            # contiguous while keeping the packed row's stride.
            piece = packed[:, col:col + width].clone(
                memory_format=torch.contiguous_format)
            col += width
            out.append(piece.view(t.dtype).reshape(
                (packed.shape[0],) + tuple(t.shape[1:])))
        it = iter(out)
        return [None if t is None else next(it) for t in tensors]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled exchange of ``jax.lax.all_to_all(x, split_axis=0,
        concat_axis=0, tiled=True)``: dim 0 of ``x`` (the same shape on
        every rank) is cut into ``size`` blocks, and block j of shard i
        lands as block i of shard j, in shard order. The blocks travel
        as bytes, so every dtype keeps its bits. A group of one returns
        ``x``. The backward is the same exchange of the cotangent."""
        if self.size == 1:
            return x
        if x.shape[0] % self.size:
            raise MeshError(f"all_to_all: dim 0 of a tensor of shape "
                            f"{tuple(x.shape)} does not split into "
                            f"{self.size} blocks")
        if _needs_grad(x):
            return _AllToAll.apply(x, self)
        return self._a2a(x)

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        t = x.contiguous().reshape(self.size, -1).view(torch.uint8)
        if self.backend == "gloo":
            t = t.cpu()
        elif t.device.type != "cuda":
            raise MeshError(f"backend='nccl' exchanges CUDA tensors; got a "
                            f"tensor on {t.device}")
        # all_to_all_single cuts its input in process-group rank order:
        # shard i's block goes to, and comes from, group rank _order[i].
        identity = self._order == list(range(self.size))
        send = t if identity else t[self._inverse]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.pg)
        if not identity:
            recv = recv[self._order]
        return recv.to(dev).view(x.dtype).reshape(x.shape)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This shard's rows of the sum over the shards (``psum_scatter``
        along dim ``dim``, tiled): dim ``dim`` of ``x`` (the same shape
        on every rank) is cut into ``size`` blocks, block i of every
        shard is sent to shard i (one ``all_to_all``) and added there in
        shard order, so that each shard holds the bits of its rows of
        :meth:`psum`. The backward all-gathers the cotangent (each
        shard's partial feeds every row of the sum)."""
        if self.size == 1:
            return x
        if dim % x.dim():
            return self.reduce_scatter(x.movedim(dim, 0)).movedim(0, dim)
        if x.shape[0] % self.size:
            raise MeshError(f"reduce_scatter: dim 0 of a tensor of shape "
                            f"{tuple(x.shape)} does not split into "
                            f"{self.size} blocks")
        if _needs_grad(x):
            return _ReduceScatter.apply(x, self)
        return self._scatter_sum(x)

    def _scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        blocks = self._a2a(x).reshape((self.size, x.shape[0] // self.size)
                                      + tuple(x.shape[1:]))
        acc = blocks[0]
        for b in blocks[1:]:
            acc = acc + b
        return acc

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the shards, added in shard order: the same bits on
        every rank on every backend. The result is replicated: the
        backward passes its cotangent through to ``x``."""
        if self.pg is not None and _needs_grad(x):
            return _Psum.apply(x, self)
        return self._sum(x)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def psum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated over the group) as it enters shard-local
        work: the identity, whose backward is the :meth:`psum` of the
        cotangent (every shard's contribution to ``x``'s gradient)."""
        if self.size == 1 or not _needs_grad(x):
            return x
        return _PsumGrad.apply(x, self)

    def shard_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This shard's rows of ``x`` (replicated over the group): dim
        ``dim`` (0 unless given) cut into ``size`` blocks in shard order
        (``P(axes)`` in). The backward all-gathers the cotangent, so
        that ``x``'s gradient is whole on every rank."""
        if dim % x.dim():
            return self.shard_rows(x.movedim(dim, 0)).movedim(0, dim)
        n, rem = divmod(x.shape[0], self.size)
        if rem:
            raise MeshError(f"shard_rows: dim 0 of a tensor of shape "
                            f"{tuple(x.shape)} does not split into "
                            f"{self.size} blocks")
        if self.size > 1 and _needs_grad(x):
            return _ShardRows.apply(x, self)
        return x[self.index * n:(self.index + 1) * n]

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        _forward_only("pmax", x)
        return torch.amax(torch.stack(self._exchange(x)), dim=0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        _forward_only("pmin", x)
        return torch.amin(torch.stack(self._exchange(x)), dim=0)


_GATHER_GRADS = ("rows", "reduce_scatter")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _forward_only(name: str, *tensors) -> None:
    if _needs_grad(*tensors):
        raise MeshError(f"ShardGroup.{name} is forward-only: it carries no "
                        f"gradient, and this tensor requires one; detach it "
                        f"or run under torch.no_grad()")


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reduce):
        ctx.group, ctx.reduce, ctx.rows = group, reduce, x.shape[0]
        return group._gather(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return ctx.group.reduce_scatter(g), None, None
        i = ctx.group.index * ctx.rows
        return g[i:i + ctx.rows], None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group._scatter_sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group._a2a(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group._sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.psum(g), None


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[0] // group.size
        return x[group.index * n:(group.index + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g), None


class Mesh:
    """Named mesh axes over the ranks of a ``torch.distributed`` world.

    ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does; ``rank`` and ``world`` are the
    global rank and world size; ``backend`` is ``"nccl"`` or ``"gloo"``.
    Build one with :func:`make_mesh`."""

    def __init__(self, device_mesh, names: Tuple[str, ...],
                 sizes: Tuple[int, ...], backend: str):
        self.device_mesh = device_mesh
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.backend = backend
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.coords = dict(zip(names, _unravel(self.rank, sizes)))
        self._groups: Dict[frozenset, object] = {}
        # Every subset of the axes, every coordinate of the other axes:
        # created here, in one order on every rank.
        for r in range(1, len(names) + 1):
            for subset in itertools.combinations(names, r):
                self._make_groups(subset)

    def _members(self, axes: Tuple[str, ...], fixed: Dict[str, int]):
        """Global ranks with the coordinates ``fixed`` off ``axes``, in
        the shard order of ``axes`` (major to minor as listed)."""
        sizes = [self.shape[a] for a in axes]
        out = []
        for idx in itertools.product(*(range(s) for s in sizes)):
            coords = dict(fixed, **dict(zip(axes, idx)))
            out.append(_ravel([coords[a] for a in self.axis_names],
                              [self.shape[a] for a in self.axis_names]))
        return out

    def _make_groups(self, subset: Tuple[str, ...]) -> None:
        rest = [a for a in self.axis_names if a not in subset]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            ranks = self._members(subset, dict(zip(rest, fixed)))
            if len(subset) == len(self.axis_names):
                pg = dist.group.WORLD
            elif len(subset) == 1:
                pg = None  # the DeviceMesh's own group, picked below
            else:
                pg = dist.new_group(ranks=sorted(ranks))
            if self.rank in ranks:
                if pg is None:
                    pg = self.device_mesh.get_group(mesh_dim=subset[0])
                self._groups[frozenset(subset)] = pg

    def size(self, axes) -> int:
        """The number of shards over ``axes``."""
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's flat shard index over ``axes``, listed from major
        to minor (the JAX package's ``_flat_axis_index``)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes) -> ShardGroup:
        """The :class:`ShardGroup` of this rank over ``axes`` (over no
        axes: this rank alone)."""
        axes = _axes(axes)
        if not axes:
            return ShardGroup((self.rank,), None, self.backend)
        missing = [a for a in axes if a not in self.shape]
        if missing or len(set(axes)) != len(axes):
            raise MeshError(f"axes {axes!r} are invalid: each must be one "
                            f"of the mesh's axes {list(self.shape)}, once")
        fixed = {a: self.coords[a] for a in self.axis_names
                 if a not in axes}
        return ShardGroup(self._members(axes, fixed),
                          self._groups[frozenset(axes)], self.backend)

    def barrier(self) -> None:
        dist.barrier()

    def describe(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return (f"Mesh({axes}; backend={self.backend}, rank {self.rank} "
                f"of {self.world}; {self.group(self.axis_names).transport})")

    __repr__ = describe


def _unravel(rank: int, sizes: Sequence[int]) -> List[int]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _ranks_per_card(world: int) -> int:
    """The most ranks of this world that share one card: a launcher's
    local world size over the cards the host has."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count()
    if cards == 0:
        return local
    return -(-local // cards)


def make_mesh(axis_shapes, axis_names, *, backend: str) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names`` over the ranks of
    the ``torch.distributed`` world, on ``backend`` (``"nccl"`` or
    ``"gloo"``).

    The world comes from ``dist.init_process_group`` (the caller's, or
    one made here from a launcher's environment, ``torchrun``'s RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT) and must have the mesh's
    size and the same backend. ``nccl`` needs a card for each rank:
    asking for it with two ranks on one card raises, naming the field.
    With nccl each rank selects its card (LOCAL_RANK, else its rank)."""
    names = _axes(axis_names)
    sizes = tuple(int(s) for s in axis_shapes)
    if len(names) != len(sizes) or len(set(names)) != len(names):
        raise MeshError(f"axis_names={names!r} is invalid: one distinct "
                        f"name for each of the {len(sizes)} axes "
                        f"{sizes!r}")
    if backend not in BACKENDS:
        raise MeshError(f"make_mesh backend={backend!r} is invalid: "
                        f"accepted values are {list(BACKENDS)}")
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise MeshError(
                "make_mesh needs a torch.distributed world: call "
                "dist.init_process_group(backend, init_method=..., rank=, "
                "world_size=) first, or run under torchrun")
        world = int(os.environ["WORLD_SIZE"])
        if backend == "nccl" and _ranks_per_card(world) > 1:
            raise _nccl_shared(world)
        dist.init_process_group(backend)
    world = dist.get_world_size()
    if backend == "nccl" and _ranks_per_card(world) > 1:
        raise _nccl_shared(world)
    if dist.get_backend() != backend:
        raise MeshError(f"make_mesh backend={backend!r} does not match the "
                        f"torch.distributed world's backend "
                        f"{dist.get_backend()!r}")
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise MeshError(f"axis_shapes={sizes!r} is invalid: the mesh must "
                        f"hold the world's {world} ranks, it holds {n}")
    from torch.distributed.device_mesh import DeviceMesh
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank())))
    dm = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                    torch.arange(world).reshape(sizes),
                    mesh_dim_names=names)
    return Mesh(dm, names, sizes, backend)


def _nccl_shared(world: int) -> MeshError:
    return MeshError(
        f"make_mesh backend='nccl' is invalid here: NCCL takes one rank per "
        f"card, and this world puts {world} ranks on "
        f"{torch.cuda.device_count()} card(s); use backend='gloo' to share "
        f"a card (collectives staged through the host)")
