"""Tree helpers over nested dict/list/tuple containers of tensors.

The port keeps the reference's pytree structure (VGG-5 is a list of
``{"w", "b"}`` dicts; SGD state is ``{"mu", "step"}``), so these few
functions replace ``jax.tree``. Dict keys are visited in sorted order,
as ``jax.tree`` does.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

Tree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten_like(tree: Tree, leaves: List[Any]) -> Tree:
    """Rebuild ``tree``'s structure from ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            out = [rebuild(x) for x in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)
    return rebuild(tree)


def to_numpy(tree: Tree) -> Tree:
    """Tensors -> numpy arrays (bf16 as float32: numpy has no bf16)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                x = x.float()
            return x.numpy()
        return np.asarray(x)
    return tree_map(conv, tree)

