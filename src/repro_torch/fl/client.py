"""Client-side local training (port of ``repro.fl.client``).

``LocalTrainer`` runs a client's local round eagerly, one step per batch of
the ``batch_plan``, on the device the global parameters live on.  Three step
forms, as in the reference:

* full (FNU): gradient and Adam over the whole tree;
* partial: only the trainable group's leaves require grad, so autograd
  builds no weight gradient for frozen layers, and Adam state exists for the
  group only;
* fused (``fused=True``): full-tree gradient, then one launch of the
  masked-Adam kernel, a one-client cohort (``optim.partial.fused_adam``)
  that trains the blocks of the round's group (BN running moments excluded
  via ``is_local_stat``); the parameters live as views in one packed buffer
  for the whole local round (``optim.partial.PackedTree``), and packed
  m / v start from zero at every local round.

BN running moments ride along the forward pass and are spliced in after
every update, in every form.  Batches are gathered on the device and losses
stay there until the round ends, so a round syncs the host once.

``groups=`` (a per-client layer plan's group set) trains that set: the
pruned partial step over it, or the fused step with its group mask.

``run_cohort_round`` is the functional local round of a stacked cohort
(the vmap engine's): the gradient of every client's step comes from one
``torch.func.vmap`` of ``torch.func.grad_and_value`` over the client axis,
and with ``fused=True`` the parameters live in one packed ``(clients, rows,
128)`` buffer — the gradient is taken with respect to each client's packed
``(rows, 128)`` slice, so it arrives in the kernel's layout — and one
cohort masked-Adam launch (``MaskedAdamCohort``) per step updates every
client in place.  The launch sits outside the ``vmap``: a ctypes call
cannot be batched.  On a homogeneous partial round (a group, no per-client
plan) the gradient is taken with respect to the group's leaves alone, as
views of the packed buffer, and written into the trained rows of a packed
gradient buffer whose other rows the kernel never reads: autograd builds
no frozen layer's weight gradient and no backward below the lowest
trained layer.

Profiler ranges (``torch.profiler.record_function``; with no profiler on,
each costs only its enter and exit): ``FL_BATCHES`` around a local round's
batch plan and the copy of its data to the device, ``FL_LOCAL_STEP`` around
each local step, and inside it ``FL_GRAD`` around the gradient and
``FL_OPTIMIZER`` around the update (``optim.partial``'s labels); inside
``FL_GRAD``, ``FL_GRAD_PRUNED`` where the fused cohort step takes the
group's gradient alone.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import aggregation, masking
from repro_torch.core.partition import Partition
from repro_torch.data.pipeline import ClientDataset, batch_plan
from repro_torch.fl.algorithms import AlgoConfig, augment_loss
from repro_torch.fl.tasks import TaskAdapter
from repro_torch.kernels.masked_adam import MaskedAdamCohort
from repro_torch.kernels.masked_adam import ops as madam_ops
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.optim.partial import (FL_GRAD, FL_GRAD_PRUNED, FL_OPTIMIZER, PackedTree,
                                       fused_adam, fused_masked_step,
                                       guard_fused_config, value_and_grad)
from repro_torch.tree import (PyTree, tree_from_paths, tree_leaves, tree_map,
                              tree_map_with_path, tree_paths)

FUSED_BLOCK_ROWS = 8     # kernel block granularity the fused step packs to

# profiler labels of a local round
FL_BATCHES = "fl.batches"         # batch plans, the clients' data to the device, the stack
FL_LOCAL_STEP = "fl.local_step"   # one local step: gradient, update, BN-moment splice


@dataclasses.dataclass
class LocalTrainer:
    adapter: TaskAdapter
    partition: Partition
    algo: AlgoConfig
    adam: AdamConfig

    def __post_init__(self):
        self._group_masks: dict[Any, torch.Tensor] = {}
        self._group_ids: dict[str, torch.Tensor] = {}

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
        with record_function(FL_GRAD):
            (loss, stats), grads = value_and_grad(
                lambda p: self._total_loss(p, inputs, labels, global_params,
                                           prev_params),
                params, has_aux=True)
        with record_function(FL_OPTIMIZER):
            new_params, new_state = adam_update(grads, opt_state, params, self.adam)
        if stats is not None:
            new_params = masking.tree_update(new_params, stats)
        return new_params, new_state, loss

    def partial_step(self, group, params, opt_state, inputs, labels,
                     global_params, prev_params):
        """Partial step for ``group`` (an int, or a plan's group set):
        gradient and Adam over its subtree."""
        trainable = masking.select(params, self.partition, group)
        frozen = masking.complement(params, self.partition, group)
        with record_function(FL_GRAD):
            (loss, stats), grads = value_and_grad(
                lambda sub: self._total_loss(masking.merge(sub, frozen), inputs,
                                             labels, global_params, prev_params),
                trainable, has_aux=True)
        with record_function(FL_OPTIMIZER):
            new_sub, new_state = adam_update(grads, opt_state, trainable, self.adam)
        new_params = masking.merge(new_sub, frozen)
        if stats is not None:
            new_params = masking.tree_update(new_params, stats)
        return new_params, new_state, loss

    def group_mask(self, group, device) -> torch.Tensor:
        """The fused step's ``(groups,)`` int32 row of trained groups for
        ``group`` (an int, a plan's group set, or every group when
        ``group < 0``); built once per (group, device) and kept there."""
        key = (group, str(device))
        if key not in self._group_masks:
            sel = range(self.partition.num_groups) if group == -1 else (
                [group] if isinstance(group, (int, np.integer)) else group)
            row = np.isin(np.arange(self.partition.num_groups), list(sel))
            self._group_masks[key] = torch.as_tensor(row.astype(np.int32),
                                                     device=device)
        return self._group_masks[key]

    def group_ids(self, params: PyTree) -> torch.Tensor:
        """Per-block layer-group ids of the fused layout (``-1`` for BN
        running moments and never trained), the cohort kernel's ``gid``;
        built once per device."""
        device = tree_leaves(params)[0].device
        if str(device) not in self._group_ids:
            gids = madam_ops.block_group_ids(params, self.partition, FUSED_BLOCK_ROWS,
                                             exclude=aggregation.is_local_stat)
            self._group_ids[str(device)] = torch.as_tensor(gids, device=device)
        return self._group_ids[str(device)]

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
        step_tracker=None,
        groups=None,
        fused: bool = False,
    ) -> tuple[PyTree, float]:
        """Train locally; returns (updated full params, mean loss).

        ``groups`` (a per-client layer plan) overrides ``group`` with a set
        of trainable groups; a set covering every group is the FNU step.
        ``fused`` routes every step through the masked-Adam kernel.
        ``step_tracker`` (a ``core.telemetry.StepSizeTracker``) records every
        step's update norm, which syncs the host once per step."""
        prev = prev_params if prev_params is not None else global_params
        sel = group                       # an int (-1: every group) or a set
        if groups is not None:
            sel = tuple(sorted(int(g) for g in groups))
            if len(sel) == self.partition.num_groups:
                sel = -1
        device = tree_leaves(global_params)[0].device
        with record_function(FL_BATCHES):
            plan = torch.as_tensor(batch_plan(len(data), batch_size, epochs, seed),
                                   device=device)
            inputs = torch.as_tensor(data.inputs, device=device)
            labels = torch.as_tensor(np.asarray(data.labels, np.int64), device=device)
        losses = []
        if fused:
            packed = PackedTree.from_tree(global_params, FUSED_BLOCK_ROWS)
            scalars = madam_ops.adam_scalars(
                torch.arange(1, len(plan) + 1, device=device), self.adam.lr,
                self.adam.b1, self.adam.b2, self.adam.eps)
            adam = fused_adam(packed, self.group_ids(global_params),
                              self.group_mask(sel, device), scalars, self.adam,
                              block_rows=FUSED_BLOCK_ROWS)
            params = packed.detached()
            for i, idx in enumerate(plan):
                with record_function(FL_LOCAL_STEP):
                    x, y = inputs[idx], labels[idx]
                    # the step writes the views in place: keep a copy to measure
                    before = (tree_map(torch.clone, params) if step_tracker is not None
                              else None)
                    loss, stats = fused_masked_step(
                        lambda p: self._total_loss(p, x, y, global_params, prev),
                        packed, adam, i)
                    masking.tree_update_(params, stats)
                    losses.append(loss)
                    if step_tracker is not None:
                        step_tracker.record(before, params)
        else:
            if sel == -1:
                opt_state = adam_init(global_params)
                step = self.full_step
            else:
                opt_state = adam_init(
                    masking.select(global_params, self.partition, sel))
                step = partial(self.partial_step, sel)
            params = global_params
            for idx in plan:
                with record_function(FL_LOCAL_STEP):
                    before = params
                    params, opt_state, loss = step(
                        params, opt_state, inputs[idx], labels[idx], global_params,
                        prev)
                    losses.append(loss)
                    if step_tracker is not None:
                        step_tracker.record(before, params)
        return params, float(torch.stack(losses).mean()) if losses else 0.0

    # -- cohort local round (the vmap engine's) ------------------------------

    def run_cohort_round(
        self,
        global_params: PyTree,
        inputs: torch.Tensor,          # (K, steps, bs, ...) on the device
        labels: torch.Tensor,          # (K, steps, bs)
        step_valid: np.ndarray,        # (K, steps) 0 / 1, padded at the tail
        *,
        group: int = -1,               # the round's group (FULL_NETWORK = -1)
        plan_rows: np.ndarray | None = None,   # (K, M) bool per-client plan
        prev_params: PyTree | None = None,     # stacked (K, ...) MOON prev models
        fused: bool = False,
    ) -> tuple[PyTree, torch.Tensor]:
        """Train ``K`` stacked clients from ``global_params`` together; returns
        (stacked locals ``(K, ...)``, ``(K,)`` mean losses on the device).

        A padded step (``step_valid`` 0) computes but leaves the client's
        parameters, optimizer state, BN moments and loss as they were — the
        reference's pad-and-mask ``where(keep, ...)``.  Fused, a partial
        round without ``plan_rows`` differentiates the group's leaves alone
        (the pruned form of ``_cohort_unfused``).  With ``plan_rows`` a
        client trains its own group set: the fused path reads it as the
        cohort kernel's group mask; the unfused path runs the FNU-shaped
        step and keeps a leaf's update only where the client's bit for its
        group is set (Eq. 1's masked form, as the reference's plan step);
        BN moments always update on a valid step."""
        num, steps = step_valid.shape
        device = inputs.device
        m_groups = self.partition.num_groups
        if plan_rows is None:
            gm = np.zeros((num, m_groups), dtype=bool)
            gm[:, :] = True if group < 0 else np.arange(m_groups) == group
        else:
            gm = np.asarray(plan_rows, dtype=bool)
        keep_cols = torch.as_tensor(np.ascontiguousarray(step_valid.T) > 0,
                                    device=device)                    # (steps, K)
        all_valid = step_valid.all(axis=0)                            # host (steps,)
        prev = prev_params if prev_params is not None else global_params
        prev_dim = 0 if prev_params is not None else None

        def f(params, x, y, pv):
            """One client's (loss, BN stats): ``torch.func.grad_and_value(
            has_aux=True)`` of it returns ``(grad, (loss, stats))``; a task
            without BN gives ``{}`` (``torch.func``'s aux holds only
            tensors)."""
            loss, stats = self._total_loss(params, x, y, global_params, pv)
            return loss, ({} if stats is None else stats)

        losses = []
        if fused:
            guard_fused_config(self.adam)
            flat, meta = madam_ops.pack(global_params, FUSED_BLOCK_ROWS)
            packed = flat.unsqueeze(0).repeat(num, 1, 1)              # (K, rows, 128)
            adam = MaskedAdamCohort(
                packed, torch.zeros_like(packed), torch.zeros_like(packed),
                self.group_ids(global_params),
                torch.as_tensor(gm, dtype=torch.int32, device=device), step_valid,
                madam_ops.adam_scalars(torch.arange(1, steps + 1, device=device),
                                       self.adam.lr, self.adam.b1, self.adam.b2,
                                       self.adam.eps),
                b1=self.adam.b1, b2=self.adam.b2, block_rows=FUSED_BLOCK_ROWS)
            params = madam_ops.unpack_stacked(packed, meta)           # views
            pruned = plan_rows is None and group >= 0
            if pruned:
                # the group's leaves, differentiated as views of ``packed``;
                # the frozen rest reaches the loss undifferentiated, so
                # autograd builds no frozen weight gradient and no backward
                # below the lowest trained layer.  The gradients land in
                # ``g``'s trained rows; its other rows stay zero, unread.
                sub = masking.select(params, self.partition, group)
                frozen = masking.complement(params, self.partition, group)
                g = torch.zeros_like(packed)
                g_sub = tree_leaves(masking.select(madam_ops.unpack_stacked(g, meta),
                                                   self.partition, group))
                grad_fn = _pruned_grad(f, prev_dim)
            else:
                grad_fn = torch.func.vmap(
                    torch.func.grad_and_value(
                        lambda fl, x, y, pv: f(_unpack_flat(fl, meta), x, y, pv),
                        has_aux=True),
                    in_dims=(0, 0, 0, prev_dim))
            for t in range(steps):
                with record_function(FL_LOCAL_STEP):
                    with record_function(FL_GRAD):
                        if pruned:
                            with record_function(FL_GRAD_PRUNED):
                                gs, (loss, stats) = grad_fn(
                                    sub, frozen, inputs[:, t], labels[:, t], prev)
                                torch._foreach_copy_(g_sub, tree_leaves(gs))
                        else:
                            g, (loss, stats) = grad_fn(packed, inputs[:, t], labels[:, t], prev)
                    with record_function(FL_OPTIMIZER):
                        adam.step(t, g.contiguous())
                    _splice_stats_(params, stats, keep_cols[t], bool(all_valid[t]))
                    losses.append(loss)
        else:
            params, losses = self._cohort_unfused(
                global_params, inputs, labels, keep_cols, gm, group,
                plan_rows is not None, prev, prev_dim, f)
        valid = torch.as_tensor(step_valid, dtype=torch.float32, device=device)
        loss_mat = torch.where(valid > 0, torch.stack(losses, dim=1).float(), 0.0)
        return params, loss_mat.sum(dim=1) / valid.sum(dim=1).clamp(min=1.0)

    def _cohort_unfused(self, global_params, inputs, labels, keep_cols, gm,
                        group, is_plan, prev, prev_dim, f):
        """``run_cohort_round`` with plain Adam (``optim.adam``) over stacked
        trees: the pruned partial step on a homogeneous partial round, the
        FNU step (with per-client leaf bits on a plan round) otherwise."""
        num, steps = inputs.shape[0], inputs.shape[1]
        params = tree_map(lambda a: a.unsqueeze(0).repeat(num, *([1] * a.dim())),
                          global_params)
        pruned = not is_plan and group >= 0
        opt = adam_init(masking.select(params, self.partition, group) if pruned
                        else params)
        bits = None
        if is_plan:
            gm_dev = torch.as_tensor(gm, device=inputs.device)
            bits = tree_map_with_path(
                lambda p, _: (torch.ones(num, dtype=torch.bool, device=inputs.device)
                              if aggregation.is_local_stat(p)
                              else gm_dev[:, self.partition.group_of(p)]),
                global_params)
        if pruned:
            grad_fn = _pruned_grad(f, prev_dim)
        else:
            grad_fn = torch.func.vmap(torch.func.grad_and_value(f, has_aux=True),
                                      in_dims=(0, 0, 0, prev_dim))
        losses = []
        for t in range(steps):
            with record_function(FL_LOCAL_STEP):
                x, y, keep = inputs[:, t], labels[:, t], keep_cols[t]
                if pruned:
                    sub = masking.select(params, self.partition, group)
                    frozen = masking.complement(params, self.partition, group)
                    with record_function(FL_GRAD):
                        g, (loss, stats) = grad_fn(sub, frozen, x, y, prev)
                    with record_function(FL_OPTIMIZER):
                        new_sub, new_opt = adam_update(g, opt, sub, self.adam)
                    new_params = masking.merge(new_sub, frozen)
                else:
                    with record_function(FL_GRAD):
                        g, (loss, stats) = grad_fn(params, x, y, prev)
                    with record_function(FL_OPTIMIZER):
                        new_params, new_opt = adam_update(g, opt, params, self.adam)
                if stats:
                    new_params = masking.tree_update(new_params, stats)

                def pick(n, o, bit=None):
                    k = keep if bit is None else keep & bit
                    return torch.where(k.view(-1, *([1] * (n.dim() - 1))), n, o)

                params = (tree_map(pick, new_params, params) if bits is None
                          else tree_map(pick, new_params, params, bits))
                opt = AdamState(new_opt.step, tree_map(pick, new_opt.m, opt.m),
                                tree_map(pick, new_opt.v, opt.v))
                losses.append(loss)
        return params, losses


def _unpack_flat(flat: torch.Tensor, meta: madam_ops.PackMeta) -> PyTree:
    """One client's tree from its packed ``(rows, 128)`` slice, for use
    inside ``torch.func``: ``split`` (whose backward is one ``cat``) and
    reshapes, so the gradient with respect to ``flat`` is assembled in the
    packed layout at the cost of one copy of the buffer, not one per
    leaf."""
    pieces = flat.reshape(-1).split(list(meta.padded))
    return tree_from_paths(
        (path, piece[:n].reshape(shape))
        for path, piece, n, shape in zip(meta.paths, pieces, meta.sizes, meta.shapes))


def _pruned_grad(f, prev_dim):
    """The vmapped gradient and value of a client's ``f`` with respect to a
    pruned subtree ``sub`` alone; the frozen rest ``fr`` reaches the loss
    undifferentiated, so autograd builds no gradient for it.

    Taken as ``torch.func.vjp`` with its backward run under ``no_grad``:
    ``torch.func.grad_and_value`` runs its backward with ``create_graph``
    (for a grad of the grad), which keeps every tensor the backward makes
    alive until it returns: on an H100, 3 clients' DeepSeek-V2-Lite
    embedding round held 66 GiB that way.  The same kernels run either way."""
    def grad_and_value(sub, fr, x, y, pv):
        loss, vjp_fn, aux = torch.func.vjp(
            lambda s: f(masking.merge(s, fr), x, y, pv), sub, has_aux=True)
        with torch.no_grad():
            (grad,) = vjp_fn(torch.ones_like(loss))
        return grad, (loss, aux)

    return torch.func.vmap(grad_and_value, in_dims=(0, 0, 0, 0, prev_dim))


@torch.no_grad()
def _splice_stats_(params: PyTree, stats: PyTree | None, keep: torch.Tensor,
                   all_valid: bool) -> None:
    """Write a cohort step's stacked BN moments into the stacked parameter
    views ``params``, for the clients whose step was valid."""
    if not stats:
        return
    items = tree_paths(stats)
    dst = []
    for path, _ in items:
        node = params
        for k in path:
            node = node[k]
        dst.append(node)
    src = [s for _, s in items]
    if not all_valid:
        src = [torch.where(keep.view(-1, *([1] * (s.dim() - 1))), s, d)
               for s, d in zip(src, dst)]
    torch._foreach_copy_(dst, src)
