"""Tree-level side of the fused masked Adam (port of
``repro/kernels/masked_adam/ops.py``): pack a parameter tree into the
kernel's ``(rows, 128)`` layout with block-aligned leaf boundaries, derive
the per-block mask from a layer-group partition, and the kernel's scalar
side input.

Layout contract (the reference's, value for value): leaves are laid out in
sorted-key order (``repro_torch.tree.tree_paths``, which is
``jax.tree.flatten``'s order), each flattened and zero-padded up to a
multiple of ``block_rows * 128`` elements, so every leaf starts on a block
boundary and a per-*block* mask can express any per-*leaf* (i.e. per
layer-group) selection.  The buffer is float32.

``unpack`` returns *views* into the packed buffer for float32 leaves, so a
tree can live inside one buffer: the fused local step (``optim.partial``)
trains such a tree and the kernel updates it in place, never packing per
step.  ``pack_stacked`` / ``unpack_stacked`` lay a client-stacked tree out
per client the same way, as ``(clients, rows, 128)``: the cohort kernel's
layout, which the vmap engine trains in place the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.partition import Partition
from repro_torch.kernels.masked_adam.kernel import LANES
from repro_torch.kernels.masked_adam.ref import plan_block_mask  # noqa: F401 (re-exported)
from repro_torch.tree import Path, PyTree, path_str, tree_from_paths, tree_paths


@dataclasses.dataclass(frozen=True)
class PackMeta:
    paths: tuple[Path, ...]
    shapes: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]
    padded: tuple[int, ...]      # padded element count per leaf
    dtypes: tuple[torch.dtype, ...]

    @property
    def rows(self) -> int:
        return sum(self.padded) // LANES


def _block_elems(block_rows: int) -> int:
    return block_rows * LANES


def _leaf_blocks(leaf, block_rows: int) -> tuple[int, int]:
    """(element count, padded element count) of one leaf."""
    n = int(np.prod(tuple(leaf.shape))) if len(leaf.shape) else 1
    return n, n + (-n) % _block_elems(block_rows)


def packed_rows(tree: PyTree, block_rows: int = 8) -> int:
    """Row count of ``pack(tree, block_rows)`` without materialising it."""
    return sum(_leaf_blocks(leaf, block_rows)[1]
               for _, leaf in tree_paths(tree)) // LANES


def pack(tree: PyTree, block_rows: int = 8) -> tuple[torch.Tensor, PackMeta]:
    """Flatten + pad each leaf to a block multiple, concat, reshape (R, 128):
    a new float32 buffer on the leaves' device."""
    items = tree_paths(tree)
    if not items:
        raise ValueError("pack needs at least one leaf")
    device = items[0][1].device
    sizes, padded = zip(*(_leaf_blocks(leaf, block_rows) for _, leaf in items))
    flat = torch.zeros(sum(padded), dtype=torch.float32, device=device)
    off = 0
    for (_, leaf), n, pn in zip(items, sizes, padded):
        flat[off:off + n] = leaf.detach().reshape(-1)
        off += pn
    meta = PackMeta(tuple(p for p, _ in items),
                    tuple(tuple(leaf.shape) for _, leaf in items),
                    tuple(sizes), tuple(padded),
                    tuple(leaf.dtype for _, leaf in items))
    return flat.view(-1, LANES), meta


def unpack(packed: torch.Tensor, meta: PackMeta) -> PyTree:
    """Invert ``pack``: float32 leaves are views into ``packed`` (writes to
    one show in the other); other dtypes are cast copies."""
    flat = packed.reshape(-1)
    out, off = [], 0
    for path, shape, n, pn, dt in zip(meta.paths, meta.shapes, meta.sizes,
                                      meta.padded, meta.dtypes):
        leaf = flat[off:off + n].view(shape)
        out.append((path, leaf if dt == torch.float32 else leaf.to(dt)))
        off += pn
    return tree_from_paths(out)


def pack_stacked(tree: PyTree, block_rows: int = 8) -> tuple[torch.Tensor, PackMeta]:
    """``pack`` for client-stacked trees (every leaf has a leading
    ``clients`` axis): returns ``(clients, R, 128)`` where each client's
    rows follow the single-tree layout exactly (``meta.shapes`` are the
    *per-client* shapes)."""
    items = tree_paths(tree)
    if not items:
        raise ValueError("pack_stacked needs at least one leaf to size the "
                         "client axis")
    clients = items[0][1].shape[0]
    for path, leaf in items:
        if leaf.shape[0] != clients:
            raise ValueError(f"stacked leaves disagree on the client axis: "
                             f"{leaf.shape[0]} vs {clients} at {path_str(path)}")
    sizes, padded = zip(*(_leaf_blocks(leaf[0], block_rows) for _, leaf in items))
    flat = torch.zeros((clients, sum(padded)), dtype=torch.float32,
                       device=items[0][1].device)
    off = 0
    for (_, leaf), n, pn in zip(items, sizes, padded):
        flat[:, off:off + n] = leaf.detach().reshape(clients, -1)
        off += pn
    meta = PackMeta(tuple(p for p, _ in items),
                    tuple(tuple(leaf.shape[1:]) for _, leaf in items),
                    tuple(sizes), tuple(padded),
                    tuple(leaf.dtype for _, leaf in items))
    return flat.view(clients, -1, LANES), meta


def unpack_stacked(packed: torch.Tensor, meta: PackMeta) -> PyTree:
    """Invert ``pack_stacked`` (leading client axis on every leaf); float32
    leaves are views into ``packed``, as ``unpack``'s are."""
    clients = packed.shape[0]
    flat = packed.reshape(clients, -1)
    out, off = [], 0
    for path, shape, n, pn, dt in zip(meta.paths, meta.shapes, meta.sizes,
                                      meta.padded, meta.dtypes):
        leaf = flat[:, off:off + n].view((clients,) + shape)
        out.append((path, leaf if dt == torch.float32 else leaf.to(dt)))
        off += pn
    return tree_from_paths(out)


# ---------------------------------------------------------------------------
# Block-mask builders (host-side, static layout)
# ---------------------------------------------------------------------------

def block_group_ids(
    tree: PyTree,
    partition: Partition,
    block_rows: int = 8,
    exclude: Callable[[str], bool] | None = None,
) -> np.ndarray:
    """Per-block layer-group id aligned with ``pack``'s layout.  Blocks of
    leaves matched by ``exclude`` (e.g. ``aggregation.is_local_stat`` for BN
    running moments) get id ``-1``: never kernel-trained."""
    ids = []
    for path, leaf in tree_paths(tree):
        nblocks = _leaf_blocks(leaf, block_rows)[1] // _block_elems(block_rows)
        p = path_str(path)
        gid = -1 if (exclude is not None and exclude(p)) else partition.group_of(p)
        ids.extend([gid] * nblocks)
    return np.asarray(ids, dtype=np.int32)


def block_mask_for_group(
    tree: PyTree, partition: Partition, groups, block_rows: int = 8,
    exclude: Callable[[str], bool] | None = None,
) -> np.ndarray:
    """Per-block int32 mask aligned with ``pack``'s layout: 1 where the
    block's leaf belongs to ``groups`` (an int or a set of group ids), 0
    elsewhere.  ``exclude`` forces matched leaves' blocks to 0."""
    sel = {groups} if isinstance(groups, (int, np.integer)) \
        else set(int(g) for g in groups)
    gids = block_group_ids(tree, partition, block_rows, exclude)
    return np.where(np.isin(gids, sorted(sel)) & (gids >= 0), 1, 0).astype(
        np.int32)


def block_masks_for_plan(
    tree: PyTree, partition: Partition, plan, block_rows: int = 8,
    exclude: Callable[[str], bool] | None = None,
) -> np.ndarray:
    """Per-client per-block masks for a ``(clients, M)`` layer-plan bitmask:
    row ``c`` is ``block_mask_for_group`` of client ``c``'s trained group
    set.  Shape ``(clients, nblocks)`` int32.  ``plan_block_mask`` (from
    ``ref``) is its device-side counterpart."""
    p = np.asarray(plan, dtype=bool)
    if p.ndim != 2 or p.shape[1] != partition.num_groups:
        raise ValueError(
            f"plan shape {p.shape} does not match "
            f"{partition.num_groups} layer groups")
    gids = block_group_ids(tree, partition, block_rows, exclude)
    out = np.zeros((p.shape[0], gids.shape[0]), dtype=np.int32)
    valid = gids >= 0
    out[:, valid] = p[:, gids[valid]]
    return out


def adam_scalars(step: torch.Tensor, lr: float, b1: float, b2: float,
                 eps: float) -> torch.Tensor:
    """The kernel's scalar side input ``[lr, 1-b1**t, 1-b2**t, eps]`` in f32,
    computed on ``step``'s device (no host sync), as
    ``optim.adam.adam_update`` computes its bias corrections.  ``step`` is
    the 1-based count; a ``(n,)`` step vector gives an ``(n, 4)`` table whose
    rows are contiguous, ready to hand to the kernel."""
    t = step.to(torch.float32)
    return torch.stack([torch.full_like(t, lr), 1.0 - torch.pow(b1, t),
                        1.0 - torch.pow(b2, t), torch.full_like(t, eps)], dim=-1)
