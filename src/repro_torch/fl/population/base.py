"""``ClientPopulation`` — the client-store contract (port of
``repro.fl.population.base``).

* ``num_clients``            — the population size N;
* ``dataset(client_id)``     — that client's shard;
* ``num_samples(client_id)`` — the shard size;
* ``capacity_tier(client_id, num_tiers)`` — the client's capacity tier for
  per-client layer plans (round-robin by id, never an O(N) table).

``MaterializedPopulation`` wraps a host-side ``Sequence[ClientDataset]``;
``as_population`` is the one seam both runtimes go through.  Streaming
populations build shards on demand (``fl.population.synthetic``).
"""

from __future__ import annotations

import abc
from typing import Sequence

from repro_torch.data.pipeline import ClientDataset


class ClientPopulation(abc.ABC):
    """Lazy client-state factory: everything is a function of (seed, id)."""

    @property
    @abc.abstractmethod
    def num_clients(self) -> int:
        """Population size N."""

    @abc.abstractmethod
    def dataset(self, client_id: int) -> ClientDataset:
        """The client's dataset shard, deterministic in client_id."""

    def num_samples(self, client_id: int) -> int:
        return len(self.dataset(client_id))

    def capacity_tier(self, client_id: int, num_tiers: int) -> int:
        """Round-robin by id, as ``core.schedule.PlanAssigner.tier_of``."""
        return int(client_id) % max(1, num_tiers)

    def _check_id(self, client_id: int) -> int:
        cid = int(client_id)
        if not 0 <= cid < self.num_clients:
            raise IndexError(
                f"client_id {cid} out of range for population of "
                f"{self.num_clients}")
        return cid

    def materialize(self) -> list[ClientDataset]:
        """Every shard, built eagerly (tests and tiny populations only)."""
        n = self.num_clients
        if n > 100_000:
            raise ValueError(
                f"refusing to materialize {n} clients host-side; sample a "
                "cohort instead")
        return [self.dataset(i) for i in range(n)]


class MaterializedPopulation(ClientPopulation):
    """A host-side ``Sequence`` of ``ClientDataset`` as a population."""

    def __init__(self, clients: Sequence[ClientDataset]):
        self._clients = list(clients)
        if not self._clients:
            raise ValueError("population must contain at least one client")

    @property
    def num_clients(self) -> int:
        return len(self._clients)

    def dataset(self, client_id: int) -> ClientDataset:
        return self._clients[self._check_id(client_id)]

    def num_samples(self, client_id: int) -> int:
        return len(self._clients[self._check_id(client_id)])


def as_population(clients) -> ClientPopulation:
    """Pass a ``ClientPopulation`` through, wrap a ``Sequence[ClientDataset]``
    in ``MaterializedPopulation``."""
    if isinstance(clients, ClientPopulation):
        return clients
    return MaterializedPopulation(clients)
