"""Weights carried between the JAX package and the port, without JAX.

* ``from_numpy_tree`` — a nested dict of numpy arrays (the reference's
  params through ``jax.tree.map(np.asarray, params)``) to a tree of tensors
  on ``device``; values, dtypes, keys and shapes are kept as they are.
* ``to_numpy_tree`` — the inverse.
* ``load_npz`` — reads a ``.npz`` written by the reference's
  ``checkpoint.io.save_pytree``, whose keys are the leaf paths joined with
  ``##``, into a nested dict of numpy arrays.

bfloat16 has no numpy dtype of its own: JAX hands out ``ml_dtypes.bfloat16``
arrays, which ``torch.tensor`` refuses and ``Tensor.numpy()`` cannot make.
Such leaves cross as their raw 16-bit words (``int16`` views on both
sides), so no value is rounded on the way.  A ``.npz`` keeps such an array
as 2-byte void words (``|V2``, ``BF16_WORDS``): ``from_numpy_tree`` reads
those as bf16 too, so ``load_npz`` + ``from_numpy_tree`` restore a bf16
checkpoint bit for bit (``checkpoint.io``).  The port itself does not need
``ml_dtypes``: only ``to_numpy_tree`` imports it, and only for a bf16 leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import PyTree, tree_from_paths, tree_map

_SEP = "##"
BF16_WORDS = np.dtype("V2")   # how np.savez keeps a bfloat16 array


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_WORDS:
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy_tree(tree: PyTree, device: str | torch.device = "cpu") -> PyTree:
    return tree_map(lambda a: _to_tensor(a, device), tree)


def to_numpy_tree(tree: PyTree) -> PyTree:
    return tree_map(_to_numpy, tree)


def load_npz(path: str) -> PyTree:
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return tree_from_paths((tuple(k.split(_SEP)), data[k]) for k in data.files)
