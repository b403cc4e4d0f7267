"""SGD (+momentum) over path-keyed trees of tensors (port of
``repro.optim.sgd``, which nothing in the reference calls: kept for DLG
experiments and ablations).  Functional, op for op the reference's."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.tree import PyTree, tree_map


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.01
    momentum: float = 0.0


class SGDState(NamedTuple):
    velocity: PyTree


def sgd_init(params: PyTree) -> SGDState:
    return SGDState(velocity=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


@torch.no_grad()
def sgd_update(grads: PyTree, state: SGDState, params: PyTree,
               cfg: SGDConfig) -> tuple[PyTree, SGDState]:
    def upd(g, v, p):
        v_new = cfg.momentum * v + g.float()
        return (p.float() - cfg.lr * v_new).to(p.dtype), v_new

    out = tree_map(upd, grads, state.velocity, params)
    # walked by params' structure, so each (p, v) pair stays a leaf
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), SGDState(velocity=pick(1))
