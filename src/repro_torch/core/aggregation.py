"""Server-side aggregation, full, partial and per-client plan (port of
``repro.core.aggregation``).

FNU rounds average every parameter; partial rounds average only the
trainable group's (pruned) subtrees and splice them into the global model.
Per the paper (§4, following FedBN), client-local statistics (BatchNorm
running moments) are *never* aggregated, on full and partial rounds alike:
they are filtered by path suffix.

Two layouts: lists of trees (the sequential engine's) and one tree with a
leading client axis (``*_stacked``, the vmap engine's: one weighted
reduction per leaf).  Heterogeneous cohorts (per-client layer plans) use
the ``aggregate_plan*`` pair: each layer group is averaged over only the
clients whose plan bit for it is set, with its own denominator; a group
nobody trained keeps the global verbatim.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import masking
from repro_torch.core.partition import Partition
from repro_torch.tree import PyTree, tree_leaves, tree_map, tree_map_with_path

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


def debias_weights(weights: np.ndarray, inclusion_probs: np.ndarray) -> np.ndarray:
    """Horvitz–Thompson debiasing: each client's aggregation weight divided
    by its inclusion probability (in float64, cast back to the weights'
    dtype), so availability-biased cohorts leave the expected objective
    unbiased.  With every probability exactly 1.0 the input array itself
    comes back."""
    probs = np.asarray(inclusion_probs, dtype=np.float64)
    if probs.shape != np.shape(weights):
        raise ValueError(f"{probs.shape} inclusion probs for "
                         f"{np.shape(weights)} weights")
    if ((probs <= 0.0) | (probs > 1.0)).any():
        raise ValueError("inclusion probabilities must lie in (0, 1]")
    if (probs == 1.0).all():
        return weights
    return (np.asarray(weights, dtype=np.float64) / probs).astype(
        np.asarray(weights).dtype)


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


def _stacked_weights(num: int, weights, device) -> torch.Tensor:
    """Normalised ``(num,)`` f32 client weights on ``device``."""
    if weights is None:
        return torch.full((num,), 1.0 / num, dtype=torch.float32, device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    if w.shape != (num,):
        raise ValueError(f"weights shape {tuple(w.shape)} != ({num},)")
    if w.device.type == "cpu" and float(w.sum()) <= 0.0:
        # a device tensor is not value-checked here (that would sync); the
        # vmap engine checks its host weights before the round
        raise ValueError(
            f"client weights must sum to a positive value, got {float(w.sum())}")
    return w / w.sum()


def tree_mean_stacked(stacked: PyTree, weights=None) -> PyTree:
    """Weighted mean over the leading *client* axis of a stacked tree: one
    ``tensordot`` per leaf, on the leaves' device."""
    leaves = tree_leaves(stacked)
    w = _stacked_weights(leaves[0].shape[0], weights, leaves[0].device)
    return tree_map(
        lambda leaf: torch.tensordot(w, leaf.float(), dims=1).to(leaf.dtype),
        stacked)


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


def aggregate_full_stacked(global_params: PyTree, stacked_params: PyTree,
                           weights=None) -> PyTree:
    """``aggregate_full`` over a stacked (client-axis) tree, on the device."""
    return _splice_skipping_local_stats(global_params,
                                        tree_mean_stacked(stacked_params, weights))


def aggregate_partial_stacked(global_params: PyTree, stacked_params: PyTree,
                              partition: Partition, group: int,
                              weights=None) -> PyTree:
    """``aggregate_partial`` over stacked *full* client params: select the
    trainable group under the client axis, average with one reduction per
    leaf, splice — BN running moments excluded as in the list path."""
    sub = masking.select(stacked_params, partition, group)
    averaged = drop_local_stats(tree_mean_stacked(sub, weights))
    return masking.tree_update(global_params, averaged)


# ---------------------------------------------------------------------------
# Per-client layer plans (heterogeneous cohorts)
# ---------------------------------------------------------------------------

def plan_group_denominators(plan: Any, weights: Any) -> np.ndarray:
    """Per-group denominators under a ``(clients, M)`` plan: group ``g``'s is
    the weight sum of exactly the clients that trained it (0 when nobody
    did, and the group keeps the global verbatim)."""
    p = np.asarray(plan, dtype=np.float32)
    w = np.asarray(weights, dtype=np.float32)
    if p.ndim != 2 or w.shape != (p.shape[0],):
        raise ValueError(f"plan {p.shape} / weights {w.shape} mismatch")
    return w @ p


def aggregate_plan(global_params: PyTree, client_subtrees: Sequence[PyTree],
                   partition: Partition, plan: Any,
                   weights: Sequence[float]) -> PyTree:
    """Per-group participant-weighted aggregation (list path):
    ``client_subtrees[i]`` holds at least client ``i``'s trained groups.
    Each group is averaged over only the clients whose plan row sets its
    bit, with its own denominator; a group nobody trained keeps the global
    verbatim; BN running moments never travel."""
    p = np.asarray(plan, dtype=bool)
    if len(client_subtrees) != p.shape[0]:
        raise ValueError(
            f"{len(client_subtrees)} client trees for plan of {p.shape[0]}")
    new_params = global_params
    for g in range(p.shape[1]):
        members = np.flatnonzero(p[:, g])
        if members.size == 0:
            continue                      # zero-trainer group: frozen global
        subs = [masking.select(client_subtrees[i], partition, g) for i in members]
        averaged = drop_local_stats(
            tree_mean(subs, [float(weights[i]) for i in members]))
        new_params = masking.tree_update(new_params, averaged)
    return new_params


def aggregate_plan_stacked(global_params: PyTree, stacked_params: PyTree,
                           partition: Partition, plan: Any, weights: Any) -> PyTree:
    """``aggregate_plan`` over stacked full client params, on the device: a
    leaf of group ``g`` is averaged with the plan-masked weights
    ``w * plan[:, g]`` over that group's own denominator; a zero-trainer
    group's leaves stay the global's, bit for bit (``torch.where``)."""
    leaves = tree_leaves(stacked_params)
    num, device = leaves[0].shape[0], leaves[0].device
    plan_f = torch.as_tensor(np.asarray(plan, dtype=np.float32), device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    if plan_f.shape != (num, partition.num_groups) or w.shape != (num,):
        raise ValueError(
            f"plan {tuple(plan_f.shape)} / weights {tuple(w.shape)} do not match "
            f"{num} stacked clients x {partition.num_groups} groups")
    eff = w[:, None] * plan_f                       # (clients, M)
    denom = eff.sum(dim=0)                          # (M,)
    trained = denom > 0
    wg_all = eff / torch.where(trained, denom, torch.ones_like(denom))

    def _leaf(path, g_leaf, s_leaf):
        if is_local_stat(path):
            return g_leaf
        g = partition.group_of(path)
        avg = torch.tensordot(wg_all[:, g], s_leaf.float(), dims=1)
        return torch.where(trained[g], avg.to(g_leaf.dtype), g_leaf)

    return tree_map_with_path(_leaf, global_params, stacked_params)
