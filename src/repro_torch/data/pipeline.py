"""Batching pipeline for the FL simulation: per-client epoch iterators with
deterministic shuffling, plus a balanced held-out eval set (the paper tests
the global model on a balanced set).

A numpy-only copy of ``repro.data.pipeline``, value-identical, including
``stack_client_batches``: the batched engines' pad-and-mask stacking
(clients bucketed by batch width, ragged step counts padded at the tail,
and with ``pad_clients_to`` the client axis padded for the shard_map
engine).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

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


@dataclasses.dataclass
class StackedClientBatches:
    """One bucket of same-batch-width clients, stacked along a client axis.

    ``inputs``/``labels`` carry a leading ``(clients, steps, bs, ...)`` shape;
    ``step_valid`` is ``(clients, steps)`` float32 — 0.0 marks padded steps
    whose results the batched engine discards (the pad-and-mask contract).
    ``members`` maps bucket rows back to positions in the round's picked-client
    order.
    """

    inputs: np.ndarray
    labels: np.ndarray
    step_valid: np.ndarray
    members: tuple[int, ...]

    @property
    def num_clients(self) -> int:
        return self.inputs.shape[0]

    @property
    def num_steps(self) -> int:
        return self.inputs.shape[1]

    @property
    def batch_width(self) -> int:
        return self.inputs.shape[2]


def stack_client_batches(
    datasets: Sequence[ClientDataset],
    batch_size: int,
    epochs: int,
    seeds: Sequence[int],
    *,
    pad_clients_to: int = 1,
) -> list[StackedClientBatches]:
    """Stack the round's clients into vmap-ready buckets.

    Clients are bucketed by effective batch width ``min(batch_size, n)`` (one
    batch shape per bucket); within a bucket, ragged step counts are
    padded with the client's first batch and masked out via ``step_valid``.

    ``pad_clients_to`` rounds each bucket's client axis up to a multiple of
    it by appending padding clients (the first member's data, ``step_valid``
    all zero): the shard_map engine gives every rank the same number of
    clients, and a padding client carries zero aggregation weight.
    ``members`` lists the real clients only.
    """
    out = []
    for members, plans, valid in bucket_plans(datasets, batch_size, epochs, seeds,
                                              pad_clients_to=pad_clients_to):
        src = [datasets[i] for i in members]
        src += [src[0]] * (len(plans) - len(src))
        out.append(StackedClientBatches(
            inputs=np.stack([d.inputs[pl] for d, pl in zip(src, plans)]),
            labels=np.stack([d.labels[pl] for d, pl in zip(src, plans)]),
            step_valid=valid, members=members))
    return out


def bucket_plans(
    datasets: Sequence[ClientDataset],
    batch_size: int,
    epochs: int,
    seeds: Sequence[int],
    *,
    pad_clients_to: int = 1,
) -> list[tuple[tuple[int, ...], np.ndarray, np.ndarray]]:
    """The index side of ``stack_client_batches``: per bucket, ``(members,
    plans, step_valid)`` with ``plans`` the ``(clients, steps, bs)`` batch
    indices into each client's own dataset, so an engine can gather the
    batches where the data lives.  Rows past ``len(members)`` are the
    padding clients of ``pad_clients_to``: the first member's plan, never
    valid."""
    if len(datasets) != len(seeds):
        raise ValueError("one seed per client dataset is required")
    if pad_clients_to < 1:
        raise ValueError(f"pad_clients_to must be >= 1, got {pad_clients_to}")
    buckets: dict[int, list[int]] = {}
    for pos, ds in enumerate(datasets):
        buckets.setdefault(min(batch_size, len(ds)), []).append(pos)

    out = []
    for bs in sorted(buckets):
        members = buckets[bs]
        plans = [batch_plan(len(datasets[p]), batch_size, epochs, seeds[p])
                 for p in members]
        max_steps = max(len(pl) for pl in plans)
        padded, valid = [], []
        for plan in plans:
            pad = max_steps - len(plan)
            if pad:
                plan = np.concatenate([plan, np.repeat(plan[:1], pad, axis=0)])
            padded.append(plan)
            v = np.zeros(max_steps, dtype=np.float32)
            v[: max_steps - pad] = 1.0
            valid.append(v)
        for _ in range(-len(members) % pad_clients_to):
            padded.append(padded[0])
            valid.append(np.zeros(max_steps, dtype=np.float32))
        out.append((tuple(members), np.stack(padded), np.stack(valid)))
    return out


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
