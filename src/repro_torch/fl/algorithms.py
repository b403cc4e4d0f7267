"""FL algorithm plugins: FedAvg, FedProx, MOON (port of
``repro.fl.algorithms``).

An algorithm contributes a loss *augmentation* on top of the task loss:

    FedAvg : nothing
    FedProx: + (mu/2)·‖w − w_global‖²   over trainable params
    MOON   : + mu·contrastive(z_local, z_global, z_prev)
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import PyTree, tree_leaves


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    name: str = "fedavg"            # fedavg | fedprox | moon
    prox_mu: float = 0.01
    moon_mu: float = 1.0
    moon_tau: float = 0.5


def prox_term(params: PyTree, global_params: PyTree) -> torch.Tensor:
    """``Σ‖w − w_global‖²`` over matching leaves, summed in sorted-key order."""
    total = None
    for a, b in zip(tree_leaves(params), tree_leaves(global_params)):
        sq = torch.sum((a.float() - b.float()) ** 2)
        total = sq if total is None else total + sq
    return total


def moon_contrastive(z: torch.Tensor, z_glob: torch.Tensor, z_prev: torch.Tensor,
                     tau: float) -> torch.Tensor:
    """Model-contrastive loss (Li et al. 2021): pull the local representation
    towards the global model's, push it from the previous local model's."""

    def cos(a, b):
        a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
        b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
        return torch.sum(a * b, dim=-1)

    pos = cos(z, z_glob) / tau
    neg = cos(z, z_prev) / tau
    return torch.mean(-pos + torch.logsumexp(torch.stack([pos, neg]), dim=0))


def augment_loss(
    algo: AlgoConfig,
    task_loss: torch.Tensor,
    *,
    params: PyTree | None = None,
    global_params: PyTree | None = None,
    z: torch.Tensor | None = None,
    z_glob: torch.Tensor | None = None,
    z_prev: torch.Tensor | None = None,
) -> torch.Tensor:
    if algo.name == "fedavg":
        return task_loss
    if algo.name == "fedprox":
        return task_loss + 0.5 * algo.prox_mu * prox_term(params, global_params)
    if algo.name == "moon":
        return task_loss + algo.moon_mu * moon_contrastive(z, z_glob, z_prev, algo.moon_tau)
    raise ValueError(f"unknown algorithm {algo.name!r}")
