"""Per-client state store (port of ``repro.fl.population.store``, the
unbounded form).

MOON keeps each client's previous local model across rounds under
``("moon", client_id)``.  Unbounded (``max_entries=0``) the store is a plain
map; values stay on the device they were trained on.  The bounded LRU with
disk spill is not ported yet and is refused (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Any, Hashable

from repro_torch.tree import PyTree


class ClientStateStore:
    """Map ``(kind, client_id) -> tree``; ``get`` of an unseen key is None."""

    def __init__(self, max_entries: int = 0, spill_dir: str | None = None):
        if max_entries < 0:
            raise ValueError(f"max_entries must be >= 0, got {max_entries}")
        if max_entries or spill_dir:
            raise NotImplementedError(
                "a bounded or spilling client state store is not ported yet "
                "(ROADMAP Queue 1 item 10); use max_entries=0, spill_dir=None")
        self._mem: dict[tuple[str, Hashable], Any] = {}

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: tuple[str, Hashable]) -> bool:
        return key in self._mem

    def get(self, kind: str, client_id: Hashable) -> PyTree | None:
        return self._mem.get((kind, client_id))

    def put(self, kind: str, client_id: Hashable, tree: PyTree) -> None:
        self._mem[(kind, client_id)] = tree
