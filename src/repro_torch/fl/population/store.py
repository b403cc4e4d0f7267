"""Bounded per-client state store: LRU in memory, optional spill to disk
(port of ``repro.fl.population.store``).

Per-client state that persists across rounds — MOON's previous local model
(``"moon"``) and compression error-feedback residuals (``"ef"``) — lives
here under ``(kind, client_id)``.  ``max_entries=0`` (the default) is
unbounded: a plain map.  With ``max_entries > 0`` the least recently used
entry is evicted when the store grows past the bound, and then either

* **spilled** — written to ``spill_dir`` with ``torch.save`` and reloaded
  by the next ``get``, value-exact, on the device it was stored from; or
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

import torch

from repro_torch.tree import PyTree, tree_map


def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy when it is a view into a larger buffer (which
    ``torch.save`` would write whole)."""
    return t if t.untyped_storage().nbytes() == t.nbytes else t.clone()


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
            tree = torch.load(self._path(key), weights_only=True)
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
                    torch.save(tree_map(_own_storage, old_tree), self._path(old_key))
                    self._spilled.add(old_key)
                    self.spills += 1
                else:
                    self._spilled.discard(old_key)

    def stats(self) -> dict:
        return {"in_memory": len(self._mem), "on_disk": len(self._spilled),
                "evictions": self.evictions, "spills": self.spills,
                "loads": self.loads, "max_entries": self.max_entries}
