"""The plain reference of a synchronous FedAvg round with local Adam, and the
weights, data and seeds the benchmark hands to both sides.

It works out again, from the same inputs and with nothing of the program:

* which clients a round trains, in which order (Floyd's draw from
  ``np.random.default_rng(fl_seed)``, one generator per call of the
  program's round loop) and each client's batch order (its seed from
  ``SeedSequence((fl_seed, round, client))``, one permutation per local
  epoch, full batches only);
* each client's local Adam steps on the round's trained leaves (the group's
  on a partial round, every leaf on a full one; BatchNorm running moments
  never), with autograd over those leaves alone, so no gradient of a frozen
  leaf is formed;
* FedAvg: the sample-weighted mean of the clients' trained leaves, spliced
  into the global parameters; every other leaf keeps its global value.

A configuration's ``reference.py`` gives the model: its leaves, their layer
groups, its loss and its data.  Parameters are flat dicts from ``a/b/c``
paths to tensors; ``nest`` turns one into the nested dict the program takes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Seeds, trees, weights
# ---------------------------------------------------------------------------

def sub_seed(seed: int, *keys: int) -> int:
    """A seed of its own for each use of the run's ``--seed``."""
    return int(np.random.SeedSequence((int(seed), *keys)).generate_state(1, np.uint64)[0]
               % (2 ** 62))


def path_key(path: str) -> tuple[str, ...]:
    """Sort key of a path: key by key, as a nested dict flattens in sorted
    order at every level."""
    return tuple(path.split("/"))


def nest(flat: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(flatten(tree[k], path))
        else:
            out[path] = tree[k]
    return out


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its path, shape, initial distribution (``std`` of a
    zero-mean normal, or the constant ``fill``) and layer group."""

    path: str
    shape: tuple[int, ...]
    group: int
    std: float = 0.0
    fill: float = 0.0
    local_stat: bool = False      # a BatchNorm running moment: never trained or sent

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def init_params(leaves: list[Leaf], seed: int, device) -> dict[str, torch.Tensor]:
    """Every normal leaf from one draw of a ``torch.Generator`` on
    ``device``, the rest filled, all float32."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    drawn = [lf for lf in leaves if lf.std > 0]
    noise = torch.randn(sum(lf.numel for lf in drawn), generator=gen, device=device)
    out, off = {}, 0
    for lf in sorted(leaves, key=lambda lf: path_key(lf.path)):
        if lf.std > 0:
            out[lf.path] = noise[off:off + lf.numel].view(lf.shape).mul(lf.std)
            off += lf.numel
        else:
            out[lf.path] = torch.full(lf.shape, lf.fill, dtype=torch.float32,
                                      device=device)
    return out


# ---------------------------------------------------------------------------
# The round loop's draws
# ---------------------------------------------------------------------------

def client_round_seed(seed: int, round_index: int, client_id: int) -> int:
    ss = np.random.SeedSequence((int(seed), int(round_index), int(client_id)))
    return int(ss.generate_state(1, np.uint32)[0])


def draw_cohort(rng: np.random.Generator, n: int, k: int) -> list[int]:
    """Floyd's uniform k-subset of ``range(n)``, in draw order."""
    chosen: set[int] = set()
    out = []
    for j in range(n - k, n):
        t = int(rng.integers(0, j + 1))
        pick = t if t not in chosen else j
        chosen.add(pick)
        out.append(pick)
    return out


def batch_plan(n: int, batch_size: int, epochs: int, seed: int) -> np.ndarray:
    """(steps, bs) sample indices: a permutation per epoch, full batches."""
    rng = np.random.default_rng(seed)
    bs = min(batch_size, n)
    rows = []
    for _ in range(epochs):
        order = rng.permutation(n)
        for start in range(0, max(n - bs + 1, 1), bs):
            rows.append(order[start:start + bs])
    return np.stack(rows).astype(np.int64)


# ---------------------------------------------------------------------------
# Reference rounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Readings:
    """What a run of the first rounds gives to compare: each round's loss,
    the first local step's gradient norm of every client and trained leaf
    of the first round (``first_grads[client][path]``), and the parameters
    after the last round."""

    losses: list[float]
    first_grads: list[dict[str, float]]
    params: dict[str, torch.Tensor]
    grad_rule: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class FedSetup:
    """One run's federation: per-client data on the host, the traffic's
    local-training settings and the round loop's seed."""

    clients: list[tuple[np.ndarray, np.ndarray]]
    batch_size: int
    local_epochs: int
    lr: float
    adam_eps: float
    fl_seed: int
    b1: float = 0.9
    b2: float = 0.999


def trained_paths(leaves: list[Leaf], group: int) -> list[str]:
    """The leaves a round trains: the group's (every group's for ``-1``),
    BatchNorm running moments never, in sorted order."""
    return sorted((lf.path for lf in leaves
                   if not lf.local_stat and (group < 0 or lf.group == group)),
                  key=path_key)


def _local_round(loss_fn, gparams, train, x, y, plan, fed: FedSetup,
                 half_batch: bool):
    p = {k: gparams[k].clone() for k in train}
    m = {k: torch.zeros_like(p[k]) for k in train}
    v = {k: torch.zeros_like(p[k]) for k in train}
    losses, first = [], {}
    for t, idx in enumerate(plan, start=1):
        idx_t = torch.as_tensor(idx[: len(idx) // 2] if half_batch else idx,
                                device=x.device)
        leaves = {k: p[k].detach().requires_grad_(True) for k in train}
        loss = loss_fn({**gparams, **leaves}, x[idx_t], y[idx_t])
        grads = torch.autograd.grad(loss, [leaves[k] for k in train])
        tf = torch.tensor(float(t), dtype=torch.float32, device=x.device)
        bc1 = 1.0 - torch.pow(fed.b1, tf)
        bc2 = 1.0 - torch.pow(fed.b2, tf)
        with torch.no_grad():
            for k, g in zip(train, grads):
                if t == 1:
                    first[k] = float(torch.linalg.vector_norm(g))
                m[k] = fed.b1 * m[k] + (1 - fed.b1) * g
                v[k] = fed.b2 * v[k] + (1 - fed.b2) * (g * g)
                p[k] = p[k] - fed.lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2)
                                                       + fed.adam_eps)
        losses.append(loss.detach())
    return p, float(torch.stack(losses).mean()), first


def reference_rounds(loss_fn, leaves: list[Leaf], params0: dict[str, torch.Tensor],
                     rounds: list[tuple[int, int]], fed: FedSetup, device, *,
                     half_batch: bool = False, drop_splice: int = -1) -> Readings:
    """Run ``rounds`` (``(index, group)``, ``group -1`` = full network) of
    one call of the round loop from ``params0``; every client of the
    population takes part in every round.  Faults the comparison has to
    catch: ``half_batch`` leaves out half of every batch; ``drop_splice``
    loses the aggregate of the ``drop_splice``-th round."""
    n = len(fed.clients)
    rng = np.random.default_rng(fed.fl_seed)
    gparams = {k: t.detach().to(device, copy=True) for k, t in params0.items()}
    data = [(torch.as_tensor(x, device=device),
             torch.as_tensor(np.asarray(y, np.int64), device=device))
            for x, y in fed.clients]
    out = Readings(losses=[], first_grads=[], params={})
    for r, (index, group) in enumerate(rounds):
        train = trained_paths(leaves, group)
        picked = draw_cohort(rng, n, n)
        weights = torch.tensor([float(len(fed.clients[c][1])) for c in picked],
                               dtype=torch.float32, device=device)
        weights = weights / weights.sum()
        new = {k: torch.zeros_like(gparams[k]) for k in train}
        losses = []
        for pos, c in enumerate(picked):
            x, y = data[c]
            plan = batch_plan(len(fed.clients[c][1]), fed.batch_size, fed.local_epochs,
                              client_round_seed(fed.fl_seed, index, c))
            local, loss, first = _local_round(loss_fn, gparams, train, x, y, plan,
                                              fed, half_batch)
            losses.append(loss)
            if r == 0:
                out.first_grads.append(first)
            if pos == 0:
                for k, g in first.items():
                    out.grad_rule.setdefault(k, g)
            with torch.no_grad():
                for k in train:
                    new[k] += weights[pos] * local[k]
        if r != drop_splice:
            gparams.update(new)
        out.losses.append(float(np.mean(losses)))
    out.params = gparams
    return out
