"""O(cohort) sampling + seed derivation (numpy-only copy of
``repro.fl.population.sampling``, value-identical: every sampler consumes a
``np.random.Generator`` exactly as the reference's does).

* ``sample_without_replacement`` — Floyd's algorithm (Bentley & Floyd, CACM
  1987): exactly ``k`` draws, ``O(k)`` memory, uniform over k-subsets.
* ``sample_excluding`` / ``IncrementalSampler`` — the same over ``range(n)``
  minus a busy set, in O(k log k + k log |busy|) (the async runtime's
  cohort sampler); with nothing excluded, Floyd's stream itself.
* ``weighted_sample_without_replacement`` — Efraimidis–Spirakis keys, the
  availability-biased cohort sampler.
* ``client_round_seed`` — per-(run, round, client) seeds hashed through
  ``np.random.SeedSequence`` (collision-free across realistic grids).
* ``resolve_cohort_size`` — clients per round from the fraction or an
  explicit cohort size.
"""

from __future__ import annotations

from bisect import bisect_right, insort
from typing import Sequence

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


def _nth_absent(rank: int, excluded: Sequence[int]) -> int:
    """The ``rank``-th natural number (0-based) not in sorted ``excluded``:
    binary search on ``id - |{e in excluded : e <= id}| == rank``."""
    lo, hi = rank, rank + len(excluded)
    while lo < hi:
        mid = (lo + hi) // 2
        if mid + 1 - bisect_right(excluded, mid) >= rank + 1:
            hi = mid
        else:
            lo = mid + 1
    return lo


def sample_excluding(rng: np.random.Generator, n: int, k: int,
                     excluded: Sequence[int]) -> list[int]:
    """Uniform k-subset of ``range(n)`` minus sorted ``excluded``: Floyd over
    the ranks of the free ids, each mapped by ``_nth_absent``.  With
    ``excluded`` empty this is ``sample_without_replacement`` (same stream,
    same result)."""
    if not excluded:
        return sample_without_replacement(rng, n, k)
    m = n - len(excluded)
    if not 0 <= k <= m:
        raise ValueError(f"need 0 <= k <= {m} available ids, got k={k}")
    return [_nth_absent(r, excluded) for r in sample_without_replacement(rng, m, k)]


def weighted_sample_without_replacement(
        rng: np.random.Generator, ids: Sequence[int],
        weights: Sequence[float], k: int) -> list[int]:
    """Weighted k-subset of ``ids`` without replacement (Efraimidis–Spirakis
    keys ``log(u) / w``, the ``k`` largest); zero-weight ids are never
    picked.  Consumes exactly one ``rng.random`` vector of ``len(ids)``."""
    ids = [int(i) for i in ids]
    w = np.asarray(list(weights), dtype=np.float64)
    if w.shape != (len(ids),):
        raise ValueError(f"need one weight per id, got {w.shape} weights "
                         f"for {len(ids)} ids")
    if (w < 0.0).any():
        raise ValueError("weights must be >= 0")
    eligible = int((w > 0.0).sum())
    if not 0 <= k <= eligible:
        raise ValueError(f"need 0 <= k <= {eligible} positive-weight ids, "
                         f"got k={k}")
    if k == 0:
        return []
    u = rng.random(len(ids))
    keys = np.full(len(ids), -np.inf)
    pos = w > 0.0
    with np.errstate(divide="ignore"):
        keys[pos] = np.log(u[pos]) / w[pos]
    order = np.argsort(-keys, kind="stable")
    return [ids[i] for i in order[:k]]


class IncrementalSampler:
    """Without-replacement sampler over ``range(n)`` minus a busy set:
    repeated ``draw(k)`` calls never repeat an id (drawn ids join the
    exclusion), so availability-rejected candidates can be topped up
    without O(n) work."""

    def __init__(self, rng: np.random.Generator, n: int,
                 busy: Sequence[int] = ()):
        self._rng = rng
        self._n = n
        self._excluded = sorted(int(b) for b in busy)

    @property
    def remaining(self) -> int:
        return self._n - len(self._excluded)

    def draw(self, k: int) -> list[int]:
        k = min(k, self.remaining)
        if k <= 0:
            return []
        out = sample_excluding(self._rng, self._n, k, self._excluded)
        for ci in out:
            insort(self._excluded, ci)
        return out
