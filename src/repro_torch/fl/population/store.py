"""Bounded per-client state store: LRU in memory, optional spill to disk
(port of ``repro.fl.population.store``).

Per-client state that persists across rounds — MOON's previous local model
(``"moon"``), compression error-feedback residuals (``"ef"``) and a
streamed population's cached dataset shards (``"data"``) — lives here
under ``(kind, client_id)``.  ``max_entries=0`` (the default) is
unbounded: a plain map.  With ``max_entries > 0`` the least recently used
entry is evicted when the store grows past the bound, and then either

* **spilled** — written to ``spill_dir`` with ``torch.save`` and reloaded
  by the next ``get``, value-exact: a tensor leaf on the device it was
  stored from, a numpy leaf (the shards) as numpy with its dtype, bit for
  bit; or
* **dropped** (no ``spill_dir``) — the next ``get`` returns ``None``, which
  consumers treat as first contact (MOON falls back to the global model,
  error feedback restarts from zero).

Entries in memory stay on the device they were trained on (the reference
moves them to host numpy; the port keeps them where the next round reads
them).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Hashable

import numpy as np
import torch

from repro_torch.tree import PyTree, tree_map, tree_paths


def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy when it is a view into a larger buffer (which
    ``torch.save`` would write whole)."""
    return t if t.untyped_storage().nbytes() == t.nbytes else t.clone()


def _to_saved(tree: PyTree) -> dict:
    """What a spill file holds: the tree with every numpy leaf carried as a
    CPU tensor over the same bytes, and the paths of those leaves, so the
    file loads under ``weights_only=True`` and ``_from_saved`` gives the
    numpy leaves back."""
    numpy_paths = [list(path) for path, leaf in tree_paths(tree)
                   if isinstance(leaf, np.ndarray)]
    tensors = tree_map(lambda x: _own_storage(
        torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x),
        tree)
    return {"tree": tensors, "numpy": numpy_paths}


def _from_saved(saved: dict) -> PyTree:
    tree = saved["tree"]
    for path in saved["numpy"]:
        if not path:
            return tree.numpy()
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]].numpy()
    return tree


class ClientStateStore:
    """LRU map ``(kind, client_id) -> tree`` with optional disk spill;
    ``max_entries`` caps the in-memory entries across kinds."""

    def __init__(self, max_entries: int = 0, spill_dir: str | None = None):
        if max_entries < 0:
            raise ValueError(f"max_entries must be >= 0, got {max_entries}")
        self.max_entries = int(max_entries)
        self.spill_dir = spill_dir
        self._mem: OrderedDict[tuple[str, Hashable], PyTree] = OrderedDict()
        self._spilled: set[tuple[str, Hashable]] = set()
        self.evictions = 0      # entries pushed out of memory (spilled or dropped)
        self.spills = 0         # evictions persisted to disk
        self.loads = 0          # disk reloads
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: tuple[str, Hashable]) -> bool:
        return key in self._mem or key in self._spilled

    def keys(self):
        return list(self._mem.keys()) + sorted(self._spilled - set(self._mem))

    def _path(self, key: tuple[str, Hashable]) -> str:
        kind, cid = key
        return os.path.join(self.spill_dir, f"{kind}-{cid}.pt")

    def get(self, kind: str, client_id: Hashable) -> PyTree | None:
        """The stored tree, or ``None`` for a never-seen or dropped entry;
        a spilled entry is reloaded from disk."""
        key = (kind, client_id)
        if key in self._mem:
            self._mem.move_to_end(key)
            return self._mem[key]
        if key in self._spilled:
            tree = _from_saved(torch.load(self._path(key), weights_only=True))
            self.loads += 1
            self._insert(key, tree)
            return tree
        return None

    def put(self, kind: str, client_id: Hashable, tree: PyTree) -> None:
        self._insert((kind, client_id), tree)

    def pop(self, kind: str, client_id: Hashable) -> None:
        """Forget an entry entirely (memory and disk)."""
        key = (kind, client_id)
        self._mem.pop(key, None)
        if key in self._spilled:
            self._spilled.discard(key)
            try:
                os.remove(self._path(key))
            except OSError:
                pass

    def _insert(self, key: tuple[str, Hashable], tree: PyTree) -> None:
        self._mem[key] = tree
        self._mem.move_to_end(key)
        if self.max_entries:
            while len(self._mem) > self.max_entries:
                old_key, old_tree = self._mem.popitem(last=False)
                self.evictions += 1
                if self.spill_dir is not None:
                    torch.save(_to_saved(old_tree), self._path(old_key))
                    self._spilled.add(old_key)
                    self.spills += 1
                else:
                    self._spilled.discard(old_key)

    def stats(self) -> dict:
        return {"in_memory": len(self._mem), "on_disk": len(self._spilled),
                "evictions": self.evictions, "spills": self.spills,
                "loads": self.loads, "max_entries": self.max_entries}
