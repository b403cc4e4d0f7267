"""Weights carried between the JAX package and the port, without JAX.

* ``from_numpy_tree`` — a nested dict of numpy arrays (the reference's
  params through ``jax.tree.map(np.asarray, params)``) to a tree of tensors
  on ``device``; values, dtypes, keys and shapes are kept as they are.
* ``to_numpy_tree`` — the inverse.
* ``load_npz`` — reads a ``.npz`` written by the reference's
  ``checkpoint.io.save_pytree``, whose keys are the leaf paths joined with
  ``##``, into a nested dict of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import PyTree, tree_from_paths, tree_map

_SEP = "##"


def from_numpy_tree(tree: PyTree, device: str | torch.device = "cpu") -> PyTree:
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def to_numpy_tree(tree: PyTree) -> PyTree:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def load_npz(path: str) -> PyTree:
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return tree_from_paths((tuple(k.split(_SEP)), data[k]) for k in data.files)
