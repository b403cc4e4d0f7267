"""Adam / AdamW over path-keyed trees of tensors (port of
``repro.optim.adam``).

``adam_update`` is functional, op for op the reference's: it returns new
tensors and never writes its inputs.  The *partial* variants in
``repro_torch.optim.partial`` wrap it over pruned trainable subtrees, so
optimizer state exists only for the round's trainable group.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.tree import PyTree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


class AdamState(NamedTuple):
    step: torch.Tensor     # int32 scalar on the params' device
    m: PyTree
    v: PyTree


def adam_init(params: PyTree) -> AdamState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=zeros, v=tree_map(torch.clone, zeros))


@torch.no_grad()
def adam_update(grads: PyTree, state: AdamState, params: PyTree,
                cfg: AdamConfig) -> tuple[PyTree, AdamState]:
    """Returns (new_params, new_state); the step count stays on the device."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    def upd(g, m, v, p):
        g32 = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * (g32 * g32)
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, grads, state.m, state.v, params)
    # walked by params' structure, so each (p, m, v) triple stays a leaf
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), AdamState(step=step, m=pick(1), v=pick(2))
