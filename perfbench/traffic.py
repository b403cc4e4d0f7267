"""The one generator of traffic: a mix's ``traffic/<name>.json`` gives the
federation (clients, samples each, split), the local training (batch,
epochs, optimizer), the eval, and the round schedule; this module turns it
into clients' data, an eval set and the list of rounds.

The loop is closed: rounds follow each other back to back, each a barrier
of fixed work, so there is no rate to set.  Every seed gets the same sizes
and the same schedule; the seed changes only the data and the weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench.fedref import sub_seed

ROUNDS = ("partial", "full")


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    rounds: str                  # "partial": one layer group a round, in order, cycling;
                                 # "full": FNU
    rounds_per_call: int         # rounds per call of the round loop
    checked_rounds: int          # the first rounds, which the reference follows
    clients: int
    samples_per_client: int
    batch_size: int
    local_epochs: int
    eval_samples: int
    eval_every: int
    lr: float
    adam_eps: float
    engine: str
    fused_adam: bool
    split: str = "iid"
    algorithm: str = "fedavg"
    why: str = ""
    source: str = ""             # where each number comes from, and what was cut

    @classmethod
    def from_json(cls, data: dict) -> "Traffic":
        t = cls(**data)
        if t.rounds not in ROUNDS:
            raise ValueError(f"traffic {t.name}: rounds must be one of {ROUNDS}")
        if t.split != "iid" or t.algorithm != "fedavg":
            raise ValueError(f"traffic {t.name}: only an iid split and FedAvg are "
                             "generated and referenced")
        if min(t.clients, t.samples_per_client, t.batch_size, t.local_epochs, t.rounds_per_call,
               t.checked_rounds, t.eval_samples, t.eval_every) < 1:
            raise ValueError(f"traffic {t.name}: sizes must be positive")
        return t

    def group(self, index: int, num_groups: int) -> int:
        return -1 if self.rounds == "full" else index % num_groups

    def schedule(self, start: int, count: int, num_groups: int) -> list[tuple[int, int]]:
        """Rounds ``start`` .. ``start + count - 1`` as ``(index, group)``,
        group ``-1`` for a full network update."""
        return [(i, self.group(i, num_groups)) for i in range(start, start + count)]

    @property
    def steps_per_client(self) -> int:
        bs = min(self.batch_size, self.samples_per_client)
        return self.local_epochs * len(range(0, max(self.samples_per_client - bs + 1, 1), bs))

    @property
    def samples_per_round(self) -> int:
        """Client samples trained in a round: every client's every batch."""
        return self.clients * self.steps_per_client * min(self.batch_size,
                                                          self.samples_per_client)

    def make_clients(self, ref, cfg: dict, seed: int):
        """Per-client ``(inputs, labels)`` from the seed: one pool drawn by
        the configuration's generator, split iid into equal shards."""
        n = self.clients * self.samples_per_client
        x, y = ref.make_data(cfg, n, sub_seed(seed, 1))
        order = np.random.default_rng(sub_seed(seed, 2)).permutation(n)
        return [(x[p], y[p]) for p in np.split(order, self.clients)]

    def make_eval(self, ref, cfg: dict, seed: int):
        return ref.make_data(cfg, self.eval_samples, sub_seed(seed, 3))
