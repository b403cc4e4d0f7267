"""Server-side aggregation, full and partial (port of
``repro.core.aggregation``, list-of-trees forms).

FNU rounds average every parameter; partial rounds average only the
trainable group's (pruned) subtrees and splice them into the global model.
Per the paper (§4, following FedBN), client-local statistics (BatchNorm
running moments) are *never* aggregated, on full and partial rounds alike:
they are filtered by path suffix.  The stacked (client-axis) forms arrive
with the vmap engine.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import masking
from repro_torch.tree import PyTree, tree_map, tree_map_with_path

# Path components that denote client-local statistics (never aggregated).
LOCAL_STAT_KEYS = ("mean_ema", "var_ema", "num_batches")


def is_local_stat(path: str) -> bool:
    return any(path.endswith(k) or f"/{k}" in path for k in LOCAL_STAT_KEYS)


def _normalized_weights(num: int, weights: Sequence[float] | None) -> list[float]:
    if weights is None:
        return [1.0 / num] * num
    if len(weights) != num:
        raise ValueError(f"{len(weights)} weights for {num} client trees")
    total = float(sum(weights))
    if total <= 0.0:
        raise ValueError(f"client weights must sum to a positive value, got {total}")
    return [float(x) / total for x in weights]


def tree_mean(trees: Sequence[PyTree], weights: Sequence[float] | None = None) -> PyTree:
    """Weighted elementwise mean of same-structure trees, accumulated in f32
    in client order (the reference's order, so results agree to rounding)."""
    w = _normalized_weights(len(trees), weights)

    def _avg(*leaves):
        acc = torch.zeros_like(leaves[0], dtype=torch.float32)
        for wi, leaf in zip(w, leaves):
            acc = acc + wi * leaf.float()
        return acc.to(leaves[0].dtype)

    return tree_map(_avg, *trees)


def _splice_skipping_local_stats(global_params: PyTree, averaged: PyTree) -> PyTree:
    """Take ``averaged`` leaves except at client-local-stat paths (keep global)."""
    return tree_map_with_path(
        lambda p, g_leaf, a_leaf: g_leaf if is_local_stat(p) else a_leaf,
        global_params, averaged)


def drop_local_stats(tree: PyTree, _prefix: str = "") -> PyTree:
    """Prune client-local-stat leaves from a (possibly pruned) dict tree."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        path = f"{_prefix}/{k}" if _prefix else str(k)
        if is_local_stat(path):
            continue
        sub = drop_local_stats(v, path)
        if isinstance(sub, dict) and not sub:
            continue
        out[k] = sub
    return out


def aggregate_full(
    global_params: PyTree,
    client_params: Sequence[PyTree],
    weights: Sequence[float] | None = None,
) -> PyTree:
    """FNU aggregation: average everything except client-local statistics."""
    averaged = tree_mean(client_params, weights)
    return _splice_skipping_local_stats(global_params, averaged)


def aggregate_partial(
    global_params: PyTree,
    client_subtrees: Sequence[PyTree],
    weights: Sequence[float] | None = None,
) -> PyTree:
    """Partial aggregation: average the pruned trainable subtrees and splice.

    ``client_subtrees`` are pruned trees (``masking.select`` output) holding
    only the round's trainable group — only those bytes travel (the paper's
    Eq. 5 comm saving).  BN running moments inside the group stay
    client-local and are excluded from the splice.
    """
    averaged = drop_local_stats(tree_mean(client_subtrees, weights))
    return masking.tree_update(global_params, averaged)
