"""Client-side local training (port of ``repro.fl.client``).

``LocalTrainer`` runs a client's local round eagerly, one step per batch of
the ``batch_plan``, on the device the global parameters live on.  Three step
forms, as in the reference:

* full (FNU): gradient and Adam over the whole tree;
* partial: only the trainable group's leaves require grad, so autograd
  builds no weight gradient for frozen layers, and Adam state exists for the
  group only;
* fused (``fused=True``): full-tree gradient, then one launch of the
  masked-Adam kernel with a per-block mask of the round's group (BN running
  moments excluded via ``is_local_stat``); the parameters live as views in
  one packed buffer for the whole local round (``optim.partial.PackedTree``),
  and packed m / v start from zero at every local round.

BN running moments ride along the forward pass and are spliced in after
every update, in every form.  Batches are gathered on the device and losses
stay there until the round ends, so a round syncs the host once.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch

from repro_torch.core import aggregation, masking
from repro_torch.core.partition import Partition
from repro_torch.data.pipeline import ClientDataset, batch_plan
from repro_torch.fl.algorithms import AlgoConfig, augment_loss
from repro_torch.fl.tasks import TaskAdapter
from repro_torch.kernels.masked_adam import ops as madam_ops
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.optim.partial import (PackedTree, fused_adam_init,
                                       fused_masked_step, guard_fused_config,
                                       value_and_grad)
from repro_torch.tree import PyTree, tree_leaves

FUSED_BLOCK_ROWS = 8     # kernel block granularity the fused step packs to


@dataclasses.dataclass
class LocalTrainer:
    adapter: TaskAdapter
    partition: Partition
    algo: AlgoConfig
    adam: AdamConfig

    def __post_init__(self):
        self._block_masks: dict[Any, torch.Tensor] = {}

    # -- loss assembly -----------------------------------------------------

    def _total_loss(self, params, inputs, labels, global_params, prev_params):
        """(augmented loss, BN-stat updates) from one training forward."""
        task, stats = self.adapter.loss_and_stats(params, inputs, labels)
        kw: dict = {}
        if self.algo.name == "fedprox":
            kw = {"params": params, "global_params": global_params}
        elif self.algo.name == "moon":
            with torch.no_grad():
                z_glob = self.adapter.features(global_params, inputs)
                z_prev = self.adapter.features(prev_params, inputs)
            kw = {"z": self.adapter.features(params, inputs),
                  "z_glob": z_glob, "z_prev": z_prev}
        return augment_loss(self.algo, task, **kw), stats

    # -- steps -------------------------------------------------------------

    def full_step(self, params, opt_state, inputs, labels, global_params,
                  prev_params):
        """FNU step: returns (new_params, new_state, loss)."""
        (loss, stats), grads = value_and_grad(
            lambda p: self._total_loss(p, inputs, labels, global_params,
                                       prev_params),
            params, has_aux=True)
        new_params, new_state = adam_update(grads, opt_state, params, self.adam)
        if stats is not None:
            new_params = masking.tree_update(new_params, stats)
        return new_params, new_state, loss

    def partial_step(self, group: int, params, opt_state, inputs, labels,
                     global_params, prev_params):
        """Partial step for ``group``: gradient and Adam over its subtree."""
        trainable = masking.select(params, self.partition, group)
        frozen = masking.complement(params, self.partition, group)
        (loss, stats), grads = value_and_grad(
            lambda sub: self._total_loss(masking.merge(sub, frozen), inputs,
                                         labels, global_params, prev_params),
            trainable, has_aux=True)
        new_sub, new_state = adam_update(grads, opt_state, trainable, self.adam)
        new_params = masking.merge(new_sub, frozen)
        if stats is not None:
            new_params = masking.tree_update(new_params, stats)
        return new_params, new_state, loss

    def block_mask(self, params: PyTree, group: int) -> torch.Tensor:
        """The fused step's per-block int32 mask for ``group`` (every group
        when ``group < 0``), BN running moments excluded; built once per
        (group, device) on the host and kept on the device."""
        device = tree_leaves(params)[0].device
        key = (group, str(device))
        if key not in self._block_masks:
            sel = (tuple(range(self.partition.num_groups)) if group < 0
                   else group)
            bm = madam_ops.block_mask_for_group(
                params, self.partition, sel, FUSED_BLOCK_ROWS,
                exclude=aggregation.is_local_stat)
            self._block_masks[key] = torch.as_tensor(bm, device=device)
        return self._block_masks[key]

    # -- local round ---------------------------------------------------------

    def run_local_round(
        self,
        global_params: PyTree,
        group: int,                    # FULL_NETWORK (-1) for FNU rounds
        data: ClientDataset,
        *,
        epochs: int,
        batch_size: int,
        seed: int,
        prev_params: PyTree | None = None,
        fused: bool = False,
    ) -> tuple[PyTree, float]:
        """Train locally; returns (updated full params, mean loss).  ``fused``
        routes every step through the masked-Adam kernel."""
        prev = prev_params if prev_params is not None else global_params
        device = tree_leaves(global_params)[0].device
        plan = torch.as_tensor(batch_plan(len(data), batch_size, epochs, seed),
                               device=device)
        inputs = torch.as_tensor(data.inputs, device=device)
        labels = torch.as_tensor(np.asarray(data.labels, np.int64), device=device)
        losses = []
        if fused:
            guard_fused_config(self.adam)
            packed = PackedTree.from_tree(global_params, FUSED_BLOCK_ROWS)
            state = fused_adam_init(packed.flat.shape[0], device)
            bm = self.block_mask(global_params, group)
            scalars = madam_ops.adam_scalars(
                torch.arange(1, len(plan) + 1, device=device), self.adam.lr,
                self.adam.b1, self.adam.b2, self.adam.eps)
            params = packed.detached()
            for i, idx in enumerate(plan):
                x, y = inputs[idx], labels[idx]
                state, loss, stats = fused_masked_step(
                    lambda p: self._total_loss(p, x, y, global_params, prev),
                    packed, state, bm, scalars[i], self.adam,
                    block_rows=FUSED_BLOCK_ROWS)
                masking.tree_update_(params, stats)
                losses.append(loss)
        else:
            if group < 0:
                opt_state = adam_init(global_params)
                step = self.full_step
            else:
                opt_state = adam_init(
                    masking.select(global_params, self.partition, group))
                step = partial(self.partial_step, group)
            params = global_params
            for idx in plan:
                params, opt_state, loss = step(
                    params, opt_state, inputs[idx], labels[idx], global_params,
                    prev)
                losses.append(loss)
        return params, float(torch.stack(losses).mean()) if losses else 0.0
