"""Client data partitioners: IID and Dirichlet(α) label-skew (paper §4 /
Table 4: α=1, Appendix F.3: α=0.1).

A numpy-only copy of ``repro.data.partitioner``, value-identical."""

from __future__ import annotations

import numpy as np


def iid_partition(
    num_samples: int, num_clients: int, seed: int = 0
) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_samples)
    return [np.sort(chunk) for chunk in np.array_split(perm, num_clients)]


def dirichlet_partition(
    labels: np.ndarray, num_clients: int, alpha: float, seed: int = 0,
    min_per_client: int = 2,
) -> list[np.ndarray]:
    """Label-skew partition: for each class, distribute its samples across
    clients with proportions ~ Dirichlet(alpha)."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    client_idx: list[list[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for client, chunk in enumerate(np.split(idx, cuts)):
            client_idx[client].extend(chunk.tolist())
    # Guarantee a minimum per client by stealing from the largest.
    sizes = [len(ci) for ci in client_idx]
    for i in range(num_clients):
        while len(client_idx[i]) < min_per_client:
            donor = int(np.argmax([len(ci) for ci in client_idx]))
            client_idx[i].append(client_idx[donor].pop())
    return [np.sort(np.array(ci, dtype=np.int64)) for ci in client_idx]


def partition_stats(parts: list[np.ndarray], labels: np.ndarray) -> np.ndarray:
    """(clients, classes) count matrix — for heterogeneity diagnostics."""
    num_classes = int(labels.max()) + 1
    out = np.zeros((len(parts), num_classes), np.int64)
    for i, idx in enumerate(parts):
        for c, n in zip(*np.unique(labels[idx], return_counts=True)):
            out[i, int(c)] = n
    return out
