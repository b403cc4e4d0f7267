"""Nested-dict parameter trees, flattened the way ``jax.tree.flatten`` does.

The port's parameters are path-keyed nested dicts of tensors.  Every walk
below visits dict keys in *sorted* order, as ``jax.tree.flatten`` does
(``blocks < head < stem`` in ResNet, ``"0" < "1" < "10"`` for block ids):
the masked-Adam pack layout and every block mask depend on that order.
``torch.utils._pytree`` walks dicts in insertion order, so it is not used.
A plain ``tuple`` is a node too, as in ``jax.tree.flatten``: its children
in order, keyed ``"0"``, ``"1"``, ... (the sLSTM cache is the reference's
``(c, n, h, m)``); ``tree_map`` rebuilds it as a tuple, ``tree_from_paths``
as a dict with those keys.  Every other value (a tensor, a ``list``, a
named tuple such as ``AdamState``) is a leaf; an empty dict holds no
leaves.  A ``tree_map`` whose ``fn`` returns tuples keeps them as leaves
only for a later walk led by a tree of the first structure
(``tree_map(lambda _, o: o[0], like, out)``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

Path = tuple[str, ...]
PyTree = Any


def _children(tree: PyTree) -> list | None:
    """``[(key, child), ...]`` of a node in walk order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if type(tree) is tuple:
        return list(enumerate(tree))
    return None


def _rebuild(tree: PyTree, items: dict) -> PyTree:
    """A node like ``tree`` with children ``items`` (key -> child)."""
    return tuple(items.values()) if type(tree) is tuple else items


def tree_paths(tree: PyTree, prefix: Path = ()) -> list[tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in sorted-key order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: list[tuple[Path, Any]] = []
    for k, sub in kids:
        out.extend(tree_paths(sub, prefix + (str(k),)))
    return out


def path_str(path: Path) -> str:
    return "/".join(path)


def tree_leaves(tree: PyTree) -> list[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over matching leaves of same-structure trees (structure and
    key order of ``tree``)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    return _rebuild(tree, {k: tree_map(fn, sub, *(r[k] for r in rest)) for k, sub in kids})


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       _prefix: Path = ()) -> PyTree:
    """``tree_map`` whose ``fn`` also receives the leaf's ``"a/b/c"`` path."""
    kids = _children(tree)
    if kids is None:
        return fn(path_str(_prefix), tree, *rest)
    return _rebuild(tree, {k: tree_map_with_path(fn, sub, *(r[k] for r in rest),
                                                 _prefix=_prefix + (str(k),))
                           for k, sub in kids})


def tree_from_paths(items: Iterable[tuple[Path, Any]]) -> PyTree:
    """Inverse of ``tree_paths``: rebuild the nested dict."""
    tree: PyTree = {}
    for path, leaf in items:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree
