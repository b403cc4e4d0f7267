"""Layer-group partitioning of parameter trees (port of
``repro.core.partition``).

The paper (Appendix A) numbers the trainable parameters of a model into M
ordered *layer groups* (#1 .. #M), shallow to deep; each conv/block weight
travels together with its accompanying norm parameters.  FedPart trains and
transmits exactly one group per communication round.  Groups are identified
by *group keys* derived from parameter paths; an ordering function sorts the
keys shallow -> deep.  Paths come from ``repro_torch.tree.tree_paths``
(sorted-key order, as ``jax.tree.flatten``), so group ids are identical to
the reference's for the same tree.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Mapping

import numpy as np

from repro_torch.tree import Path, PyTree, path_str, tree_paths

__all__ = ["Partition", "build_partition", "default_group_key",
           "default_order_key", "group_param_bytes", "group_param_counts",
           "path_str", "tree_paths"]


# ---------------------------------------------------------------------------
# Group keys
# ---------------------------------------------------------------------------

_SHALLOW_FIRST = ("embed", "embedding", "tok_embed", "patch_embed", "stem", "conv_in")
_DEEP_LAST = ("head", "lm_head", "classifier", "final_norm", "norm_f", "fc_out")

_BLOCK_RE = re.compile(r"^(blocks?|layers?|stages?|enc_blocks?|dec_blocks?)$")


def default_group_key(path: Path) -> tuple:
    """Default grouping: one group per block index, plus embed / head groups
    (every parameter of block 3, norms included, shares a group)."""
    head = path[0]
    if head in _SHALLOW_FIRST:
        return ("embed",)
    if head in _DEEP_LAST:
        return ("head",)
    if _BLOCK_RE.match(head) and len(path) > 1 and path[1].isdigit():
        return ("block", head, int(path[1]))
    return ("misc", head)


def default_order_key(group_key: tuple) -> tuple:
    kind = group_key[0]
    if kind == "embed":
        return (0,)
    if kind == "misc":
        return (1, group_key[1])
    if kind == "block":
        return (2, group_key[1], group_key[2])
    if kind == "head":
        return (3,)
    return (9, str(group_key))


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Partition:
    """An ordered partition of parameter paths into layer groups."""

    group_keys: tuple[tuple, ...]                 # ordered, shallow -> deep
    assignment: Mapping[str, int]                 # path_str -> group index

    @property
    def num_groups(self) -> int:
        return len(self.group_keys)

    def group_of(self, path: Path | str) -> int:
        key = path if isinstance(path, str) else path_str(path)
        return self.assignment[key]


def build_partition(
    params: PyTree,
    group_key_fn: Callable[[Path], tuple] = default_group_key,
    order_key_fn: Callable[[tuple], tuple] = default_order_key,
) -> Partition:
    """Build an ordered layer-group partition for ``params``."""
    keys_by_path: dict[str, tuple] = {}
    for path, _ in tree_paths(params):
        keys_by_path[path_str(path)] = group_key_fn(path)
    ordered = sorted(set(keys_by_path.values()), key=order_key_fn)
    index = {k: i for i, k in enumerate(ordered)}
    assignment = {p: index[k] for p, k in keys_by_path.items()}
    return Partition(group_keys=tuple(ordered), assignment=assignment)


# ---------------------------------------------------------------------------
# Sizes / byte accounting (used by core.costs)
# ---------------------------------------------------------------------------

def group_param_counts(params: PyTree, partition: Partition) -> np.ndarray:
    counts = np.zeros(partition.num_groups, dtype=np.int64)
    for path, leaf in tree_paths(params):
        counts[partition.group_of(path)] += leaf.numel()
    return counts


def group_param_bytes(params: PyTree, partition: Partition) -> np.ndarray:
    out = np.zeros(partition.num_groups, dtype=np.int64)
    for path, leaf in tree_paths(params):
        out[partition.group_of(path)] += leaf.numel() * leaf.element_size()
    return out


def total_param_bytes(params: PyTree) -> int:
    return int(sum(leaf.numel() * leaf.element_size() for _, leaf in tree_paths(params)))
