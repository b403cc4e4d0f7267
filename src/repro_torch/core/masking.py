"""Mask / split / merge utilities over partitioned parameter trees (port of
``repro.core.masking``).

Two equivalent realisations of the paper's Eq. 1 masked update:

* ``mask_tree``        — the paper's literal binary mask ``S`` (bool tree);
* ``select``/``merge`` — the partitioned form: the trainable group is carved
  out as a *pruned subtree*, gradients are taken w.r.t. that subtree only
  (only its leaves ``requires_grad``, so autograd never builds the frozen
  layers' weight gradients), and the result is merged back.

The stacked helpers (``stack_trees``, ``unstack_tree``,
``apply_mask_stacked``) work on trees with a leading client axis, the vmap
engine's layout.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.partition import Partition
from repro_torch.tree import (Path, PyTree, path_str, tree_map,
                              tree_map_with_path, tree_paths)

GroupSel = Sequence[int] | int


def _as_group_set(groups: GroupSel) -> frozenset[int]:
    if isinstance(groups, int):
        return frozenset((groups,))
    return frozenset(int(g) for g in groups)


def mask_tree(params: PyTree, partition: Partition, groups: GroupSel) -> PyTree:
    """Binary mask tree: True where the leaf belongs to ``groups``."""
    sel = _as_group_set(groups)
    return tree_map_with_path(
        lambda p, leaf: torch.full(tuple(leaf.shape), partition.group_of(p) in sel,
                                   dtype=torch.bool, device=leaf.device),
        params)


def apply_mask(update: PyTree, mask: PyTree) -> PyTree:
    """``S ⊙ update`` — elementwise masked update (paper Eq. 1)."""
    return tree_map(lambda u, m: torch.where(m, u, torch.zeros_like(u)), update, mask)


def select(params: PyTree, partition: Partition, groups: GroupSel) -> PyTree:
    """Return a pruned tree holding only leaves assigned to ``groups``."""
    sel = _as_group_set(groups)
    return _filter(params, (), lambda p: partition.group_of(p) in sel)


def complement(params: PyTree, partition: Partition, groups: GroupSel) -> PyTree:
    """Return a pruned tree holding every leaf *not* in ``groups``."""
    sel = _as_group_set(groups)
    return _filter(params, (), lambda p: partition.group_of(p) not in sel)


def _filter(node: PyTree, prefix: Path, keep) -> PyTree:
    if isinstance(node, dict):
        out = {}
        for k in sorted(node):
            sub = _filter(node[k], prefix + (str(k),), keep)
            if sub is not None and (not isinstance(sub, dict) or sub):
                out[k] = sub
        return out
    return node if keep(path_str(prefix)) else None


def merge(*trees: PyTree) -> PyTree:
    """Deep-merge pruned dict trees back into one tree (disjoint leaves)."""
    out: PyTree = {}
    for tree in trees:
        out = _merge2(out, tree)
    return out


def _merge2(a: PyTree, b: PyTree) -> PyTree:
    if b is None:
        return a
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _merge2(out[k], v) if k in out else v
        return out
    if a is None or (isinstance(a, dict) and not a):
        return b
    raise ValueError("merge: overlapping leaves between pruned trees")


def tree_update(base: PyTree, patch: PyTree) -> PyTree:
    """Return ``base`` with the leaves present in (pruned) ``patch`` replaced."""
    if not isinstance(base, dict):
        return patch
    out = dict(base)
    for k, v in (patch or {}).items():
        out[k] = tree_update(base[k], v) if k in out else v
    return out


# ---------------------------------------------------------------------------
# Client-axis (stacked) helpers — used by the vmap engine
# ---------------------------------------------------------------------------

def stack_trees(trees: Sequence[PyTree]) -> PyTree:
    """Stack same-structure trees along a new leading *client* axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def unstack_tree(stacked: PyTree, num_clients: int) -> list[PyTree]:
    """Inverse of ``stack_trees``: one tree per client-axis index (views into
    the stacked leaves; nothing is copied)."""
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(num_clients)]


def apply_mask_stacked(update: PyTree, mask: PyTree) -> PyTree:
    """``S ⊙ update`` where ``update`` carries a leading client axis and
    ``mask`` is an unbatched bool tree (``mask_tree`` output): the group
    mask broadcasts across clients — the paper's Eq. 1 under a client
    axis."""
    return tree_map(lambda u, m: torch.where(m[None, ...], u, torch.zeros_like(u)),
                    update, mask)


@torch.no_grad()
def tree_update_(base: PyTree, patch: PyTree) -> None:
    """In-place ``tree_update``: copy every leaf of (pruned) ``patch`` into
    the matching leaf of ``base``."""
    items = tree_paths(patch or {})
    dst = []
    for path, _ in items:
        node = base
        for k in path:
            node = node[k]
        dst.append(node)
    if dst:
        torch._foreach_copy_(dst, [t for _, t in items])
