"""Nested-dict parameter trees, flattened the way ``jax.tree.flatten`` does.

The port's parameters are path-keyed nested dicts of tensors.  Every walk
below visits dict keys in *sorted* order, as ``jax.tree.flatten`` does
(``blocks < head < stem`` in ResNet, ``"0" < "1" < "10"`` for block ids):
the masked-Adam pack layout and every block mask depend on that order.
``torch.utils._pytree`` walks dicts in insertion order, so it is not used.
Non-dict values are leaves; an empty dict holds no leaves.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

Path = tuple[str, ...]
PyTree = Any


def tree_paths(tree: PyTree, prefix: Path = ()) -> list[tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: list[tuple[Path, Any]] = []
    for k in sorted(tree):
        out.extend(tree_paths(tree[k], prefix + (str(k),)))
    return out


def path_str(path: Path) -> str:
    return "/".join(path)


def tree_leaves(tree: PyTree) -> list[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over matching leaves of same-structure trees (structure and
    key order of ``tree``)."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       _prefix: Path = ()) -> PyTree:
    """``tree_map`` whose ``fn`` also receives the leaf's ``"a/b/c"`` path."""
    if not isinstance(tree, dict):
        return fn(path_str(_prefix), tree, *rest)
    return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                  _prefix=_prefix + (str(k),))
            for k in sorted(tree)}


def tree_from_paths(items: Iterable[tuple[Path, Any]]) -> PyTree:
    """Inverse of ``tree_paths``: rebuild the nested dict."""
    tree: PyTree = {}
    for path, leaf in items:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree
