"""O(cohort) sampling + seed derivation (numpy-only copy of the sync loop's
half of ``repro.fl.population.sampling``, value-identical).

* ``sample_without_replacement`` — Floyd's algorithm (Bentley & Floyd, CACM
  1987): exactly ``k`` draws, ``O(k)`` memory, uniform over k-subsets.
* ``client_round_seed`` — per-(run, round, client) seeds hashed through
  ``np.random.SeedSequence`` (collision-free across realistic grids).
* ``resolve_cohort_size`` — clients per round from the fraction or an
  explicit cohort size.
"""

from __future__ import annotations

import numpy as np


def client_round_seed(seed: int, round_index: int, client_id: int) -> int:
    """Collision-resistant per-(run, round, client) seed."""
    ss = np.random.SeedSequence((int(seed), int(round_index), int(client_id)))
    return int(ss.generate_state(1, np.uint32)[0])


def resolve_cohort_size(n_clients: int, sample_fraction: float,
                        cohort_size: int = 0) -> int:
    """Clients per dispatch: an explicit ``cohort_size`` wins (clamped to
    the population), else the ``sample_fraction`` rounding."""
    if cohort_size:
        if cohort_size < 0:
            raise ValueError(f"cohort_size must be >= 0, got {cohort_size}")
        return max(1, min(int(cohort_size), n_clients))
    return max(1, int(round(sample_fraction * n_clients)))


def sample_without_replacement(rng: np.random.Generator, n: int, k: int
                               ) -> list[int]:
    """Floyd's algorithm: a uniform k-subset of ``range(n)`` in O(k),
    consuming exactly ``k`` draws from ``rng``."""
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
    chosen: set[int] = set()
    out: list[int] = []
    for j in range(n - k, n):
        t = int(rng.integers(0, j + 1))
        pick = t if t not in chosen else j
        chosen.add(pick)
        out.append(pick)
    return out
