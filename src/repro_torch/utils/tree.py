"""Helpers over the port's parameter trees (counterpart of
``repro/utils/tree.py``): nested dicts, tuples and lists of tensors, as
``models.common.tree_map`` walks them. ``leaves`` takes dict keys in
sorted order, as ``jax.tree.leaves`` does, so that a sum over the leaves
adds them in the reference's order."""
from __future__ import annotations

from typing import Callable, List

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``: dict keys in sorted order, sequences in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(tree, values) -> object:
    """``tree``'s nesting with its leaves replaced, in :func:`leaves`
    order, by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the tree has leaves")
    return out


def map_sorted(fn: Callable, *trees):
    """``fn`` over the leaves of ``trees`` (of one nesting), called in
    :func:`leaves` order; returns the results in the first tree's
    nesting."""
    return unflatten(trees[0], [fn(*xs) for xs in zip(*map(leaves, trees))])


def param_count(tree) -> int:
    return sum(x.numel() for x in leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def tree_norm(tree) -> torch.Tensor:
    """The global L2 norm in f32: each leaf's sum of squares, added in
    :func:`leaves` order."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves(tree)))


def check_finite(tree) -> torch.Tensor:
    """A bool scalar: every element of every leaf finite."""
    return torch.stack([torch.all(torch.isfinite(x))
                        for x in leaves(tree)]).all()
