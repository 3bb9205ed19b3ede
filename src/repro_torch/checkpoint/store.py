"""Pytree checkpoints in npz (counterpart of ``repro/checkpoint/store.py``,
numpy and torch only).

A tree of nested dicts, NamedTuples, tuples and lists is stored under
the key paths the JAX package writes (``jax.tree_util.
tree_flatten_with_path``): a dict entry by its key, a NamedTuple field
as ``.field`` and a sequence entry by its index, joined by ``/``; so
the fold state lands under ``server/.centers``. ``None`` and empty
containers hold no leaf. An archive written by either package loads in
the other.

A bfloat16 leaf, which numpy has no native form of, is stored as a
uint8 byte view beside a ``<key>__dtype__`` marker naming the dtype, and
rebuilt from its bits on load, as ``convert`` rebuilds a JAX bf16
array; ``ml_dtypes`` is never needed.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "encode_tag", "decode_tag",
           "npz_keys", "load_extras", "checkpoint_step"]

_NATIVE_KINDS = set("biufc")



def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """[(key path parts, leaf)] in the JAX package's order: dict keys
    sorted, NamedTuple fields and sequence entries in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in _flatten(v, prefix + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf):
    """A leaf as (numpy array, byte-view dtype name or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint8), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind not in _NATIVE_KINDS:
        return arr.view(np.uint8), str(arr.dtype)
    return arr, None


def save_pytree(path: str, tree, step: Optional[int] = None, *,
                mesh=None) -> str:
    """Write ``tree`` to ``path`` (``.npz`` appended if missing) and
    return the file's name. The write is atomic: the archive is written
    beside the target and renamed over it, so a crash mid-save never
    leaves a truncated file where the last good checkpoint was. With a
    ``utils.mesh.Mesh`` every rank calls this with the same tree: rank 0
    writes, and every rank returns once the file is there (a barrier)."""
    if mesh is not None:
        if mesh.rank == 0:
            save_pytree(path, tree, step)
        mesh.barrier()
        return _npz(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for parts, leaf in _flatten(tree):
        key = "/".join(parts)
        arr, marker = _host(leaf)
        if marker is not None:
            flat[key + "__dtype__"] = np.asarray(marker)
        flat[key] = arr
    if step is not None:
        flat["__step__"] = np.asarray(step)
    final = _npz(path)
    tmp = final + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, final)
    return final


def _stored(data, key):
    """The stored leaf: a numpy array, or a bf16 tensor rebuilt from its
    bits."""
    arr = data[key]
    if key + "__dtype__" not in data.files:
        return arr
    name = str(data[key + "__dtype__"])
    if name != "bfloat16":
        raise ValueError(f"checkpoint leaf {key!r} has dtype {name!r}; "
                         f"the port reads bfloat16 byte views only")
    # The byte view doubles the last axis; the 16-bit view gives it back.
    raw = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(raw.copy()).view(torch.bfloat16)


def _np_dtype(dtype) -> Optional[np.dtype]:
    """numpy's dtype for a torch or numpy dtype; None for bf16, which
    numpy has no native form of."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return None
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _cast(stored, leaf, key: str, device):
    """``stored`` in the dtype (and, for a tensor template, on the
    device) of the template ``leaf``. Shapes must match exactly. A cast
    between bf16 and another dtype goes through float32, as the JAX
    package casts."""
    shape = tuple(stored.shape)
    if shape != tuple(leaf.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {shape}, "
                         f"expected {tuple(leaf.shape)}")
    want_np = _np_dtype(leaf.dtype)
    if isinstance(stored, torch.Tensor):             # bf16
        out = (stored if want_np is None
               else stored.float().numpy().astype(want_np))
    elif want_np is None:                            # into bf16
        out = torch.from_numpy(stored.astype(np.float32)).to(torch.bfloat16)
    else:
        out = stored.astype(want_np)
    if isinstance(leaf, torch.Tensor):
        if not isinstance(out, torch.Tensor):
            out = torch.from_numpy(np.ascontiguousarray(out))
        return out.to(leaf.device if device is None else device)
    return out


def load_pytree(path: str, like, device=None):
    """Restore into the structure of ``like`` (a tree of tensors and
    numpy arrays): each leaf gets the template's shape, which must
    match, and its dtype; a tensor leaf lands on ``device`` (default:
    the template leaf's device), a numpy leaf stays numpy."""
    out = []
    with np.load(_npz(path)) as data:
        for parts, leaf in _flatten(like):
            key = "/".join(parts)
            if key not in data.files:
                raise KeyError(f"checkpoint {path!r} has no leaf {key!r}")
            out.append(_cast(_stored(data, key), leaf, key, device))
    return _unflatten(like, iter(out))


def encode_tag(s: str) -> np.ndarray:
    """A short string as a 1-d uint8 byte array, the form a schema tag
    is stored in (the v5 ``heads_tag``)."""
    return np.frombuffer(s.encode("utf-8"), np.uint8).copy()


def decode_tag(arr) -> str:
    """Inverse of :func:`encode_tag`."""
    return np.asarray(arr, np.uint8).tobytes().decode("utf-8")


def npz_keys(path: str) -> set:
    """The key paths in a checkpoint, without reading any array: how a
    restore tells the schema generations apart."""
    with np.load(_npz(path)) as data:
        return set(data.files)


def load_extras(path: str, keys) -> dict:
    """The arrays of ``keys`` that the checkpoint holds, in one open and
    without a template; a missing key is left out, so presence doubles
    as the schema probe."""
    with np.load(_npz(path)) as data:
        return {k: data[k] for k in keys if k in data.files}


def checkpoint_step(path: str) -> Optional[int]:
    with np.load(_npz(path)) as data:
        return int(data["__step__"]) if "__step__" in data.files else None
