"""DLG privacy attack + PSNR metrics (port of ``repro.fl.privacy``; paper
§4.4, Table 9, Appendix E).

Deep Leakage from Gradients (Zhu et al. 2019): recover a client's input by
optimising a dummy input whose gradients match the transmitted ones.  Under
FedPart only the trainable group's gradients are visible to the attacker —
fewer "equations" for the same unknowns — and reconstruction quality (PSNR)
drops accordingly.

The attack differentiates a gradient: the candidate's observed gradients
are built with ``create_graph=True`` and the match loss is differentiated
again with respect to the candidate (double backward).  With a group, the
gradients are taken with respect to that group's leaves only
(``masking.select``), which has the reference's values (it takes all of
them and selects).  The attacker's start is drawn from
``torch.Generator().manual_seed(cfg.seed)`` on the CPU (the reference's
distribution, not its numbers), then moved to the target's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import masking
from repro_torch.core.partition import Partition
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.tree import PyTree, tree_leaves, tree_map

LossFn = Callable[[PyTree, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DLGConfig:
    iterations: int = 300
    lr: float = 0.1
    seed: int = 0


def _grad_of_sample(loss_fn: LossFn, params: PyTree, x: torch.Tensor, *,
                    observe: Callable[[PyTree], PyTree] | None = None,
                    create_graph: bool = False) -> PyTree:
    """Gradients of ``loss_fn(params, x)`` with respect to ``params``, or to
    the pruned subtree ``observe(params)``; ``create_graph`` keeps them
    differentiable (in ``x``)."""
    with torch.enable_grad():
        sub = tree_map(lambda p: p.detach().requires_grad_(True),
                       params if observe is None else observe(params))
        loss = loss_fn(masking.tree_update(params, sub), x)
        grads = iter(torch.autograd.grad(loss, tree_leaves(sub),
                                         create_graph=create_graph))
    return tree_map(lambda _: next(grads), sub)


def _grad_match_loss(g_a: PyTree, g_b: PyTree) -> torch.Tensor:
    total = None
    for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
        sq = torch.sum((a.float() - b.float()) ** 2)
        total = sq if total is None else total + sq
    return total


def attack_objective(
    loss_fn: LossFn,
    params: PyTree,
    target_x: torch.Tensor,
    *,
    partition: Partition | None = None,
    group: int | None = None,
    observe_transform: Optional[Callable[[PyTree], PyTree]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The attacker's objective ``x_hat -> ||grads(x_hat) - observed||²``,
    differentiable in ``x_hat``; ``dlg_attack``'s arguments."""
    observe = None
    if group is not None:
        if partition is None:
            raise ValueError("a group observation needs its partition")
        observe = lambda t: masking.select(t, partition, group)  # noqa: E731
    target_g = _grad_of_sample(loss_fn, params, target_x, observe=observe)
    if observe_transform is not None:
        target_g = observe_transform(target_g)
    target_g = tree_map(torch.Tensor.detach, target_g)

    def objective(x_hat: torch.Tensor) -> torch.Tensor:
        g = _grad_of_sample(loss_fn, params, x_hat, observe=observe, create_graph=True)
        return _grad_match_loss(g, target_g)

    return objective


def dlg_attack(
    loss_fn: LossFn,
    params: PyTree,
    target_x: torch.Tensor,
    cfg: DLGConfig,
    *,
    partition: Partition | None = None,
    group: int | None = None,
    observe_transform: Optional[Callable[[PyTree], PyTree]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run DLG.  ``loss_fn(params, x)`` is the client training loss for input
    ``x`` (labels closed over — the paper's setting with known labels).

    If ``partition``/``group`` are given, the attacker only observes the
    gradients of that layer group (FedPart's transmitted subset).

    ``observe_transform`` models a lossy channel between client and attacker:
    it is applied to the *target* observation only (e.g. the int8 / 1-bit
    quantize-dequantize of ``core.compress``), while the attacker still
    matches with its own exact candidate gradients.

    Returns (reconstructed_x, the gradient-match loss of the last step's
    input)."""
    objective = attack_objective(loss_fn, params, target_x, partition=partition,
                                 group=group, observe_transform=observe_transform)
    gen = torch.Generator().manual_seed(cfg.seed)
    x_hat = (torch.randn(tuple(target_x.shape), generator=gen, dtype=target_x.dtype)
             * 0.5).to(target_x.device)
    adam_cfg = AdamConfig(lr=cfg.lr)
    opt = adam_init(x_hat)
    loss = torch.zeros((), dtype=torch.float32, device=target_x.device)
    for _ in range(cfg.iterations):
        with torch.enable_grad():
            x = x_hat.detach().requires_grad_(True)
            loss = objective(x)
            (g,) = torch.autograd.grad(loss, x)
        x_hat, opt = adam_update(g, opt, x_hat, adam_cfg)
        loss = loss.detach()
    return x_hat, loss


# ---------------------------------------------------------------------------
# Metrics (paper Eq. 8-9)
# ---------------------------------------------------------------------------

def mse(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    return torch.mean((x.float() - x_hat.float()) ** 2)


def psnr(x: torch.Tensor, x_hat: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR = −10·log10(MSE) with inputs normalised to ``data_range``."""
    m = mse(x / data_range, x_hat / data_range)
    return -10.0 * torch.log10(torch.clamp(m, min=1e-12))
