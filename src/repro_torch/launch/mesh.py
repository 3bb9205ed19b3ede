"""Production meshes (counterpart of ``repro/launch/mesh.py``).

The reference lowers its programs for 256 (or 512) chips on a forced
host platform. The port cannot start 256 ranks, so
:func:`make_production_mesh` gives one rank's view of that layout: a
:class:`MetaMesh` with the reference's axes and sizes, whose groups
(:class:`MetaGroup`) take ``meta`` tensors only. Each collective returns
this rank's output shape on the meta device (every other rank's operand
stands in as a copy of this rank's: the same shapes and dtypes) and
records its kind, count and operand bytes, the counterpart of
``launch/hlo_analysis.analyze``'s collective schedule. The model code
runs unchanged on it: ``launch/sharding.make_ctx(mesh)`` and every leaf,
batch row and cache block as a rank of the real mesh holds it. A real
mesh's collectives are recorded the same way through
:class:`CountedMesh`.

:func:`make_host_mesh` is a real mesh over a ``torch.distributed``
world (``utils/mesh.make_mesh``).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Optional, Sequence

import torch

from repro_torch.utils.mesh import (Mesh, MeshError, ShardGroup, _axes,
                                    _ravel, _unravel, make_mesh)

__all__ = ["COLLECTIVE_KINDS", "CountedGroup", "CountedMesh", "MetaGroup",
           "MetaMesh", "make_host_mesh", "make_production_mesh"]

COLLECTIVE_KINDS = ("all_gather", "psum", "reduce_scatter", "all_to_all",
                    "pmax", "pmin")

# A stand-in for a process group: the collective paths of ShardGroup
# (autograd included) are taken wherever the group has more than one
# rank.
_META_PG = object()


def _require_meta(kind: str, x: torch.Tensor) -> None:
    if x.device.type != "meta":
        raise MeshError(f"MetaGroup.{kind} takes meta tensors (a rank's "
                        f"view of a mesh that is not started); got a "
                        f"tensor on {x.device}")


def _record():
    return defaultdict(lambda: {"count": 0, "bytes": 0})


class CountedGroup(ShardGroup):
    """A :class:`utils.mesh.ShardGroup` whose collectives are recorded
    in ``record`` ({kind: {"count", "bytes"}}, the operand's bytes) as
    they are called, wherever the group has a process group (a group of
    one without one crosses no link). The data moves as ``group``'s."""

    def __init__(self, group: ShardGroup, record):
        self.__dict__.update(vars(group))
        self._record = record

    def _note(self, kind: str, x: torch.Tensor) -> None:
        if self.pg is not None:
            self._record[kind]["count"] += 1
            self._record[kind]["bytes"] += x.numel() * x.element_size()

    def _move(self, x: torch.Tensor) -> torch.Tensor:
        return ShardGroup._a2a(self, x)

    def all_gather(self, x, *, active: Optional[int] = None,
                   grad: str = "rows", dim: int = 0):
        if active is not None:
            self._note("all_gather", x)
        return super().all_gather(x, active=active, grad=grad, dim=dim)

    def _gather(self, x):
        self._note("all_gather", x)
        return super()._gather(x)

    def _sum(self, x):
        self._note("psum", x)
        return super()._sum(x)

    def _a2a(self, x):
        self._note("all_to_all", x)
        return self._move(x)

    def _scatter_sum(self, x):
        self._note("reduce_scatter", x)
        blocks = self._move(x).reshape((self.size, x.shape[0] // self.size)
                                       + tuple(x.shape[1:]))
        acc = blocks[0]
        for b in blocks[1:]:
            acc = acc + b
        return acc

    def pmax(self, x):
        self._note("pmax", x)
        return super().pmax(x)

    def pmin(self, x):
        self._note("pmin", x)
        return super().pmin(x)


class CountedMesh:
    """A ``utils.mesh.Mesh`` whose groups are :class:`CountedGroup` s
    over one ``collectives`` record (cleared by :meth:`reset`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.collectives = _record()

    def __getattr__(self, name):
        return getattr(self.mesh, name)

    def reset(self) -> None:
        self.collectives.clear()

    def group(self, axes) -> CountedGroup:
        return CountedGroup(self.mesh.group(axes), self.collectives)


class MetaGroup(CountedGroup):
    """A :class:`CountedGroup` of one rank's view: the same collectives
    and their gradients, on ``meta`` tensors; every other rank's operand
    stands in as a copy of this rank's. A group of one has no process
    group and records nothing."""

    def __init__(self, ranks: Sequence[int], index: int, record):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = index
        self.pg = _META_PG if self.size > 1 else None
        self.backend = "meta"
        self._order = list(range(self.size))
        self._inverse = list(range(self.size))
        self._record = record

    @property
    def transport(self) -> str:
        return "meta tensors, counted (no collective runs)"

    def _note(self, kind: str, x: torch.Tensor) -> None:
        _require_meta(kind, x)
        super()._note(kind, x)

    def _exchange(self, x: torch.Tensor):
        _require_meta("collective", x)
        return [x] * self.size

    def _move(self, x: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(x)


class MetaMesh:
    """One rank's view of a named mesh (the interface of
    :class:`utils.mesh.Mesh` that the model code reads): ``shape``,
    ``axis_names``, ``rank``, ``world``, ``coords``, ``size``,
    ``index`` and ``group``. ``collectives`` records every collective
    of its groups since the last :meth:`reset`."""

    backend = "meta"

    def __init__(self, axis_shapes, axis_names, *, rank: int = 0):
        names = _axes(axis_names)
        sizes = tuple(int(s) for s in axis_shapes)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise MeshError(f"axis_names={names!r} is invalid: one distinct "
                            f"name for each of the {len(sizes)} axes "
                            f"{sizes!r}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.world = math.prod(sizes)
        if not 0 <= rank < self.world:
            raise MeshError(f"rank={rank} is invalid: the mesh has "
                            f"{self.world} ranks")
        self.rank = rank
        self.coords = dict(zip(names, _unravel(rank, sizes)))
        self.collectives = _record()

    def reset(self) -> None:
        self.collectives.clear()

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes) -> MetaGroup:
        axes = _axes(axes)
        missing = [a for a in axes if a not in self.shape]
        if missing or len(set(axes)) != len(axes):
            raise MeshError(f"axes {axes!r} are invalid: each must be one "
                            f"of the mesh's axes {list(self.shape)}, once")
        sizes = [self.shape[a] for a in self.axis_names]
        ranks = []
        for flat in range(self.size(axes)):
            coords = dict(self.coords)
            for a, c in zip(axes, _unravel(flat, [self.shape[a]
                                                  for a in axes])):
                coords[a] = c
            ranks.append(_ravel([coords[a] for a in self.axis_names], sizes))
        return MetaGroup(ranks, self.index(axes), self.collectives)

    def barrier(self) -> None:
        pass

    def describe(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return (f"MetaMesh({axes}; rank {self.rank} of {self.world}; "
                f"meta tensors, collectives counted)")

    __repr__ = describe


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> MetaMesh:
    """One rank's view of 16 x 16 = 256 chips a pod, ("data", "model");
    of 2 pods, 512 chips, ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MetaMesh(shape, axes, rank=rank)


def make_host_mesh(n_data: Optional[int] = None, *,
                   backend: str = "gloo") -> Mesh:
    """A ("data",) mesh over the ranks of the ``torch.distributed`` world
    (its whole size unless ``n_data``)."""
    import torch.distributed as dist
    n = n_data or (dist.get_world_size() if dist.is_initialized()
                   else 1)
    return make_mesh((n,), ("data",), backend=backend)


def collective_table(record) -> Dict[str, Dict[str, int]]:
    """A recorded schedule as a plain dict, kinds in a fixed order."""
    return {k: dict(record[k]) for k in COLLECTIVE_KINDS if k in record}


def collective_bytes(record) -> int:
    return sum(v["bytes"] for v in record.values())
