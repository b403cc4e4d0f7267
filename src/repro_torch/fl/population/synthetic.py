"""Streaming synthetic populations: shards synthesized from (seed, id)
(port of ``repro.fl.population.synthetic``, value-identical).

* a per-client ``np.random.SeedSequence((seed, stream, client_id))`` gives
  order-independent randomness: a client's shard is the same whether it is
  the first or the millionth ever sampled;
* the shard comes from ``data.synthetic``'s generators, so a streamed client
  sees the class prototypes / Markov structure of the spec's ``proto_seed``;
* label skew follows Dirichlet(alpha): each client draws a persistent class
  distribution and samples its labels from it (``alpha = 0``: uniform);
* shard sizes are fixed or drawn per id from an inclusive range, and
  ``num_samples`` answers without building arrays.

Shards stay numpy on the host (the engines move the cohort's batches to the
device).  A bounded ``ClientStateStore`` (kind ``"data"``) caches recent
shards, optionally spilling them to ``cache_dir``; host memory stays
O(cache), never O(population).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.pipeline import ClientDataset
from repro_torch.data.synthetic import (TextDatasetSpec, VisionDatasetSpec,
                                        make_text_dataset, make_vision_dataset)
from repro_torch.fl.population.base import ClientPopulation
from repro_torch.fl.population.store import ClientStateStore

# SeedSequence stream tags: shard size / label skew vs. sample noise
_PLAN_STREAM = 0x0DA7A
_SAMPLE_STREAM = 0x5A3D5


@dataclasses.dataclass
class SyntheticPopulation(ClientPopulation):
    """A virtual fleet of ``population`` clients with on-demand shards.

    ``samples_per_client`` is an ``int`` or an inclusive ``(lo, hi)`` range
    drawn per client; ``alpha > 0`` gives each client a Dirichlet(alpha)
    label distribution; ``cache_entries`` bounds the in-memory shard cache
    (0 = cache nothing) and ``cache_dir`` spills evicted shards."""

    spec: VisionDatasetSpec | TextDatasetSpec
    population: int
    samples_per_client: int | tuple[int, int] = 64
    alpha: float = 0.0
    seed: int = 0
    cache_entries: int = 64
    cache_dir: str | None = None

    def __post_init__(self):
        if self.population < 1:
            raise ValueError(f"population must be >= 1, got {self.population}")
        if self.alpha < 0.0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        spc = self.samples_per_client
        lo, hi = (int(spc), int(spc)) if isinstance(spc, int) else (int(spc[0]),
                                                                    int(spc[1]))
        if not 1 <= lo <= hi:
            raise ValueError(
                f"samples_per_client must be >= 1 (lo <= hi), got {spc}")
        self._size_range = (lo, hi)
        if isinstance(self.spec, VisionDatasetSpec):
            self._make = make_vision_dataset
        elif isinstance(self.spec, TextDatasetSpec):
            self._make = make_text_dataset
        else:
            raise TypeError(f"unsupported dataset spec {type(self.spec)}")
        self._cache = ClientStateStore(max_entries=max(0, self.cache_entries),
                                       spill_dir=self.cache_dir)

    @property
    def num_clients(self) -> int:
        return self.population

    def num_samples(self, client_id: int) -> int:
        n, _ = self._client_plan(self._check_id(client_id))
        return n

    def dataset(self, client_id: int) -> ClientDataset:
        cid = self._check_id(client_id)
        cached = self._cache.get("data", cid)
        if cached is not None:
            return ClientDataset(inputs=cached["inputs"], labels=cached["labels"])
        n, class_probs = self._client_plan(cid)
        sample_seed = int(np.random.SeedSequence(
            (self.seed, _SAMPLE_STREAM, cid)).generate_state(1)[0])
        inputs, labels = self._make(self.spec, n, seed=sample_seed,
                                    class_probs=class_probs)
        if self.cache_entries:
            self._cache.put("data", cid, {"inputs": inputs, "labels": labels})
        return ClientDataset(inputs=inputs, labels=labels)

    def _client_plan(self, cid: int) -> tuple[int, np.ndarray | None]:
        """(shard size, class-probability vector or None): a handful of
        scalar draws, never the shard."""
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _PLAN_STREAM, cid)))
        lo, hi = self._size_range
        n = lo if lo == hi else int(rng.integers(lo, hi + 1))
        probs = None
        if self.alpha > 0.0:
            probs = rng.dirichlet(np.full(self.spec.num_classes, self.alpha))
        return n, probs

    def cache_stats(self) -> dict:
        return self._cache.stats()
