"""Partial (FedPart) optimizer steps (port of ``repro.optim.partial``).

Three realisations of the paper's Eq. 1, equal up to rounding:

* ``masked_step``      — Eq. 1 literally: full gradient, multiplied by the
  binary mask S;
* ``partitioned_step`` — gradients w.r.t. the trainable subtree only: only
  its leaves ``requires_grad``, so autograd never builds the frozen layers'
  weight gradients (the counterpart of XLA pruning the dead backward graph),
  and Adam state exists for the subtree only;
* ``fused_masked_step`` — Eq. 1 through the masked-Adam kernel
  (``kernels/masked_adam``).  The parameters live in one packed
  ``(rows, 128)`` f32 buffer as views (``PackedTree``) and their gradients
  in a second one, so autograd delivers the gradient already packed, and a
  one-client cohort launch (``fused_adam``, validated once per local round)
  updates parameters and packed m / v in place: nothing is packed or
  unpacked per step.

``fused_masked_step`` opens the local step's two profiler ranges
(``torch.profiler.record_function``), ``FL_GRAD`` and ``FL_OPTIMIZER``,
which ``fl.client`` opens around the same work of its other step forms;
``fl.client``'s fused cohort step opens ``FL_GRAD_PRUNED`` inside
``FL_GRAD`` where it differentiates the round's group alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import masking
from repro_torch.core.partition import Partition
from repro_torch.kernels.masked_adam import ops as madam_ops
from repro_torch.kernels.masked_adam.kernel import MaskedAdamCohort
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.tree import PyTree, tree_from_paths, tree_map, tree_paths

# profiler labels of a local step's two halves
FL_GRAD = "fl.grad"             # forward and backward: the step's gradient
FL_GRAD_PRUNED = "fl.grad.pruned"   # inside FL_GRAD: a gradient over the trained group only
FL_OPTIMIZER = "fl.optimizer"   # the optimizer's update of the step's parameters


def value_and_grad(loss_fn: Callable[[PyTree], Any], params: PyTree,
                   has_aux: bool = False):
    """``jax.value_and_grad`` for a tree of tensors: returns
    ``(loss, grads)`` or, with ``has_aux``, ``((loss, aux), grads)``, where
    ``loss_fn`` returns ``(loss, aux)``.  A leaf the loss does not reach gets
    a zero gradient, as in JAX."""
    req = tree_map(lambda t: t.detach().requires_grad_(True), params)
    items = tree_paths(req)
    with torch.enable_grad():
        out = loss_fn(req)
        loss, aux = out if has_aux else (out, None)
        gs = torch.autograd.grad(loss, [leaf for _, leaf in items],
                                 allow_unused=True)
    grads = tree_from_paths(
        (path, torch.zeros_like(leaf) if g is None else g)
        for (path, leaf), g in zip(items, gs))
    loss = loss.detach()
    return ((loss, aux) if has_aux else loss), grads


# ---------------------------------------------------------------------------
# Fused (masked-Adam kernel) path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedTree:
    """A float32 parameter tree held as views into one packed buffer.

    ``flat`` is the ``ops.pack`` layout of the tree; ``tree``'s leaves are
    views of it that require grad, and each leaf's ``.grad`` is preset to the
    matching view of ``grad``, so ``backward`` accumulates every gradient in
    place into the packed layout the kernel reads."""

    flat: torch.Tensor
    grad: torch.Tensor
    meta: madam_ops.PackMeta
    tree: PyTree

    @classmethod
    def from_tree(cls, params: PyTree, block_rows: int = 8) -> "PackedTree":
        bad = [p for p, leaf in tree_paths(params) if leaf.dtype != torch.float32]
        if bad:
            raise TypeError(f"the fused step trains float32 leaves only; "
                            f"{'/'.join(bad[0])} is not")
        flat, meta = madam_ops.pack(params, block_rows)
        grad = torch.zeros_like(flat)
        tree = madam_ops.unpack(flat, meta)
        for (_, leaf), (_, g) in zip(tree_paths(tree),
                                     tree_paths(madam_ops.unpack(grad, meta))):
            leaf.requires_grad_(True)
            leaf.grad = g
        return cls(flat, grad, meta, tree)

    def detached(self) -> PyTree:
        """The current parameters as plain views of ``flat`` (no grad)."""
        return madam_ops.unpack(self.flat, self.meta)


def guard_fused_config(cfg: AdamConfig) -> None:
    """The kernel implements plain Adam — weight decay would silently not be
    applied, so refuse it loudly."""
    if cfg.weight_decay:
        raise ValueError(
            "fused_adam does not support weight_decay "
            f"(got {cfg.weight_decay}); use the unfused engines")


def fused_adam(
    packed: PackedTree,
    gid: torch.Tensor,               # (blocks,) int32 group id, -1 = never trained
    gmask: torch.Tensor,             # (groups,) int32 0 / 1: the groups trained
    scalars: torch.Tensor,           # (steps, 4) ``ops.adam_scalars`` table
    cfg: AdamConfig,
    *,
    block_rows: int = 8,
) -> MaskedAdamCohort:
    """A local round's masked Adam over ``packed``: a one-client
    ``MaskedAdamCohort`` with packed m / v from zero, validated once for the
    round's ``len(scalars)`` steps; block ``b`` is trained iff ``gid[b] >=
    0`` and ``gmask[gid[b]]`` is set."""
    guard_fused_config(cfg)
    p = packed.flat[None]
    return MaskedAdamCohort(p, torch.zeros_like(p), torch.zeros_like(p), gid,
                            gmask.reshape(1, -1), np.ones((1, scalars.shape[0]), np.int32),
                            scalars, b1=cfg.b1, b2=cfg.b2, block_rows=block_rows)


def fused_masked_step(
    loss_fn: Callable[[PyTree], tuple[torch.Tensor, Any]],
    packed: PackedTree,
    adam: MaskedAdamCohort,          # ``fused_adam(packed, ...)``
    t: int,                          # 0-based local step
) -> tuple[torch.Tensor, Any]:
    """Eq. 1 through the fused kernel, in place: full-tree gradient, then
    local step ``t`` of ``adam`` on ``packed`` and its packed m / v; frozen
    blocks are left untouched.  ``loss_fn`` returns ``(loss, aux)``;
    returns ``(loss, aux)``."""
    with record_function(FL_GRAD), torch.enable_grad():
        packed.grad.zero_()
        loss, aux = loss_fn(packed.tree)
        loss.backward()
    with record_function(FL_OPTIMIZER):
        adam.step(t, packed.grad[None])
    return loss.detach(), aux


# ---------------------------------------------------------------------------
# Unfused realisations
# ---------------------------------------------------------------------------

def masked_step(
    loss_fn: Callable[[PyTree], torch.Tensor],
    params: PyTree,
    opt_state: AdamState,
    mask: PyTree,
    cfg: AdamConfig,
) -> tuple[PyTree, AdamState, torch.Tensor]:
    """Eq. 1: w ← w − γ·S⊙update(∇L).  Full-tree gradient, masked update."""
    loss, grads = value_and_grad(loss_fn, params)
    grads = masking.apply_mask(grads, mask)
    new_params, new_state = adam_update(grads, opt_state, params, cfg)
    # Mask the parameter delta too: Adam's bias correction would otherwise
    # move frozen params through stale m/v.
    new_params = tree_map(lambda n, o, m: torch.where(m, n, o),
                          new_params, params, mask)
    return new_params, new_state, loss


def partitioned_step(
    loss_fn: Callable[[PyTree], torch.Tensor],
    params: PyTree,
    partition: Partition,
    group: int,
    opt_state: AdamState | None,
    cfg: AdamConfig,
) -> tuple[PyTree, AdamState, torch.Tensor]:
    """Gradient w.r.t. the trainable subtree only; merge back after update.
    ``opt_state`` is over the *subtree* (None -> freshly initialised)."""
    trainable = masking.select(params, partition, group)
    frozen = masking.complement(params, partition, group)
    loss, grads = value_and_grad(
        lambda sub: loss_fn(masking.merge(sub, frozen)), trainable)
    if opt_state is None:
        opt_state = adam_init(trainable)
    new_sub, new_state = adam_update(grads, opt_state, trainable, cfg)
    return masking.merge(new_sub, frozen), new_state, loss


def full_step(
    loss_fn: Callable[[PyTree], torch.Tensor],
    params: PyTree,
    opt_state: AdamState,
    cfg: AdamConfig,
) -> tuple[PyTree, AdamState, torch.Tensor]:
    """FNU step (FedAvg baseline)."""
    loss, grads = value_and_grad(loss_fn, params)
    new_params, new_state = adam_update(grads, opt_state, params, cfg)
    return new_params, new_state, loss
