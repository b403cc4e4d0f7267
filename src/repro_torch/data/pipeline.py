"""Batching pipeline for the FL simulation: per-client epoch iterators with
deterministic shuffling, plus a balanced held-out eval set (the paper tests
the global model on a balanced set).

A numpy-only copy of ``repro.data.pipeline``, value-identical.  The
sequential engine is the only consumer so far; ``stack_client_batches``
(the vmap engine's pad-and-mask stacking) arrives with that engine
(ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def batch_plan(n: int, batch_size: int, epochs: int, seed: int) -> np.ndarray:
    """Deterministic batch-index plan: ``(steps, bs)`` int array.

    ``epochs`` passes of shuffled, truncated-to-full batches (at least one
    batch per epoch even if the client has < batch_size samples).  This is
    THE batch-order contract: every engine derives its batches from it.
    """
    rng = np.random.default_rng(seed)
    bs = min(batch_size, n)
    rows = []
    for _ in range(epochs):
        order = rng.permutation(n)
        for start in range(0, max(n - bs + 1, 1), bs):
            rows.append(order[start : start + bs])
    return np.stack(rows).astype(np.int64)


@dataclasses.dataclass
class ClientDataset:
    inputs: np.ndarray      # images (N,H,W,C) or tokens (N,S)
    labels: np.ndarray      # (N,)

    def __len__(self) -> int:
        return len(self.labels)

    def batches(
        self, batch_size: int, epochs: int, seed: int
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """``epochs`` passes of shuffled, truncated-to-full batches (at least
        one batch per epoch even if the client has < batch_size samples)."""
        for idx in batch_plan(len(self), batch_size, epochs, seed):
            yield self.inputs[idx], self.labels[idx]


def build_clients(
    inputs: np.ndarray, labels: np.ndarray, parts: list[np.ndarray]
) -> list[ClientDataset]:
    return [ClientDataset(inputs[p], labels[p]) for p in parts]


def balanced_eval_set(
    inputs: np.ndarray, labels: np.ndarray, per_class: int, seed: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    picks = []
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        picks.append(rng.choice(idx, size=min(per_class, len(idx)), replace=False))
    sel = np.concatenate(picks)
    rng.shuffle(sel)
    return inputs[sel], labels[sel]
