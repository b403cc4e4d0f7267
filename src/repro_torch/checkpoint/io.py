"""Checkpointing (port of ``repro.checkpoint.io``): a tree of tensors <->
``.npz`` with the reference's path-keyed flat layout (leaf paths joined
with ``##``), plus the FL round state (round index, schedule position,
seed, ...) as a JSON sidecar.

Tensors leave through ``.cpu().numpy()``, so a port checkpoint and a
reference checkpoint are one file format and each package reads the
other's.  bfloat16 has no numpy dtype: a bf16 leaf is stored as its raw
16-bit words in a 2-byte void array (``|V2``), exactly what the
reference's ``np.savez`` writes for an ``ml_dtypes.bfloat16`` array, so no
value is widened or rounded; ``load_pytree`` reads such an entry back as
``torch.bfloat16`` (``bridge.from_numpy_tree``), every other entry with
its own dtype, onto ``device``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.tree import PyTree, tree_paths

_SEP = "##"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(bridge.BF16_WORDS)
    return t.numpy()


def save_pytree(path: str, tree: PyTree) -> None:
    flat = {_SEP.join(p): _to_numpy(leaf) for p, leaf in tree_paths(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path: str, device: str | torch.device = "cpu") -> PyTree:
    return bridge.from_numpy_tree(bridge.load_npz(path), device)


def save_round_state(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(state, f, indent=2)


def load_round_state(path: str) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def save_checkpoint(directory: str, params: PyTree, round_state: dict) -> None:
    save_pytree(os.path.join(directory, "params.npz"), params)
    save_round_state(os.path.join(directory, "state.json"), round_state)


def load_checkpoint(directory: str, device: str | torch.device = "cpu"
                    ) -> tuple[PyTree, dict[str, Any]]:
    return (load_pytree(os.path.join(directory, "params.npz"), device),
            load_round_state(os.path.join(directory, "state.json")))
