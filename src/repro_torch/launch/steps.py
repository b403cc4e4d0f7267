"""Step functions of the launchers (port of ``repro.launch.steps``).

- ``make_train_step``          — FNU baseline: full-network Adam step.
- ``make_fedpart_train_step``  — the paper's technique on a served
  architecture: gradients and optimizer state restricted to one layer group
  (a layer of a stacked key such as ``blocks`` or the xLSTM's ``pairs``, or
  the ``embed`` / ``shared_attn`` / ``final_norm|head`` subtrees).
- ``make_prefill_step``        — full-sequence forward + KV cache write.
- ``make_serve_step``          — one-token decode against the cache.

The reference ``jax.jit``s these; here they are plain functions (PyTorch
runs eagerly) and the reference's ``unroll`` (a scan option) has no
counterpart.  The train steps differentiate ``api.loss`` with
``impl="plain"``, as the reference differentiates ``impl="xla"``: the
kernel wrappers refuse an input that requires grad (they have no
backward, as the TPU kernels have none).

Where XLA prunes the partial step's dead backward graph, autograd does it
here: only the group's tensors require grad, so layers after the group
get only activation gradients, layers before it no backward at all, and
the optimizer state covers the group's subtree.  A stacked group's layer
is handed to the forward as a list of per-layer views with the trained
layer's tensors in its slot (``layers.layer_slice``): putting it back into
the stacked tensor for the forward would make every layer's slice require
grad and bring the whole weight backward back.  The updated layer goes
into a new stacked tensor at the end (cast to the stack's dtype, as the
reference's ``dynamic_update_index_in_dim(..., t.astype(full.dtype))``);
no input tensor is ever written.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.tree import PyTree, tree_leaves, tree_map

STACK_KEYS = ("blocks", "moe_blocks", "pairs", "chunks", "tail", "enc_blocks", "dec_blocks")


# ---------------------------------------------------------------------------
# FNU train step
# ---------------------------------------------------------------------------

def _microbatches(batch: dict, accum: int) -> list[dict]:
    """Split the leading batch axis into ``accum`` microbatches."""
    split = tree_map(lambda x: x.reshape(accum, x.shape[0] // accum, *x.shape[1:]),
                     batch)
    return [tree_map(lambda x: x[i], split) for i in range(accum)]


def _layers(stack: PyTree) -> list[PyTree]:
    """A stacked tree as a list of per-layer trees of views."""
    n = tree_leaves(stack)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], stack) for i in range(n)]


def _view_map(fn, view: PyTree) -> PyTree:
    """``tree_map`` over a tree whose top-level values may be lists of
    per-layer trees (``layers.layer_slice`` reads either form)."""
    return {k: [tree_map(fn, t) for t in v] if isinstance(v, list) else tree_map(fn, v)
            for k, v in sorted(view.items())}


def _value_and_grad(loss_fn, view: PyTree) -> tuple[torch.Tensor, PyTree]:
    """``(loss_fn(view), d loss / d view)``: every leaf of ``view`` (read in
    ``_view_map``'s order) is a new autograd leaf on the same storage."""
    with torch.enable_grad():
        view = _view_map(lambda x: x.detach().requires_grad_(True), view)
        loss = loss_fn(view)
        leaves = []
        _view_map(leaves.append, view)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), _view_map(lambda _: next(grads), view)


def make_train_step(cfg: ModelConfig, adam: AdamConfig = AdamConfig(), *,
                    impl: str = "plain", remat: bool = True, accum: int = 1):
    """FNU step.  ``accum`` > 1 accumulates the gradients of ``accum``
    microbatches in f32 and applies their mean once, as the reference's
    ``lax.scan``; the loss is the microbatches' mean."""

    def train_step(params: PyTree, opt_state: AdamState, batch: dict):
        if accum <= 1:
            loss, grads = loss_and_grads(cfg, params, batch, impl=impl, remat=remat)
        else:
            grads = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                   device=x.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for mb in _microbatches(batch, accum):
                lv, g = loss_and_grads(cfg, params, mb, impl=impl, remat=remat)
                grads = tree_map(torch.add, grads, g)
                loss = loss + lv
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        new_params, new_state = adam_update(grads, opt_state, params, adam)
        return new_params, new_state, loss

    return train_step


def init_opt_state(params: PyTree) -> AdamState:
    return adam_init(params)


def loss_and_grads(cfg: ModelConfig, params: PyTree, batch: dict,
                   group: "StackedGroup | None" = None, *, impl: str = "plain",
                   remat: bool = True) -> tuple[torch.Tensor, PyTree]:
    """``api.loss`` and its gradient: over every leaf (each stack
    differentiated layer by layer and its gradient stacked once: slicing one
    stacked leaf that requires grad would have autograd build a stack-sized
    zero gradient per layer), or over ``group``'s subtree only (the
    partial step's)."""
    if group is not None:
        return _value_and_grad(
            lambda sub: api.loss(_forward_view(params, group, sub), cfg, batch,
                                 impl=impl, remat=remat), _select_group(params, group))
    view = {k: _layers(v) if k in STACK_KEYS else v for k, v in params.items()}
    loss, g = _value_and_grad(lambda v: api.loss(v, cfg, batch, impl=impl, remat=remat),
                              view)
    return loss, {k: tree_map(lambda *xs: torch.stack(xs), *v)
                  if isinstance(v, list) else v for k, v in g.items()}


# ---------------------------------------------------------------------------
# FedPart partial train step (stacked-layer grouping)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackedGroup:
    """One FedPart layer group of a stacked model: layer ``index`` of the
    stack at ``params[key]``; or the non-stacked subtree at ``key`` when
    ``index`` is None (embed / head / final_norm / shared_attn)."""

    key: str
    index: int | None = None


def list_groups(params: PyTree) -> list[StackedGroup]:
    """Enumerate FedPart groups shallow->deep for a stacked model."""
    groups: list[StackedGroup] = []
    if "embed" in params:
        groups.append(StackedGroup("embed"))
    for key in STACK_KEYS:
        if key in params:
            n = tree_leaves(params[key])[0].shape[0]
            groups.extend(StackedGroup(key, i) for i in range(n))
    for key in ("shared_attn", "mtp"):
        if key in params:
            groups.append(StackedGroup(key))
    tail_keys = [k for k in ("final_norm", "enc_norm", "enc_pos", "dec_pos", "head")
                 if k in params]
    if tail_keys:
        # norms/positions/head travel with the head group (Appendix-A style)
        groups.append(StackedGroup("|".join(tail_keys)))
    return groups


def _select_group(params: PyTree, group: StackedGroup) -> PyTree:
    if group.index is not None:
        return tree_map(lambda x: x[group.index], params[group.key])
    return {k: params[k] for k in group.key.split("|")}


def _inject_group(params: PyTree, group: StackedGroup, sub: PyTree) -> PyTree:
    """``params`` with the group replaced by ``sub``: a stacked group's layer
    goes into a new stacked tensor, cast to the stack's dtype."""
    out = dict(params)
    if group.index is not None:
        idx = torch.tensor([group.index], device=tree_leaves(sub)[0].device)
        out[group.key] = tree_map(
            lambda full, t: full.index_copy(0, idx, t.to(full.dtype)[None]),
            params[group.key], sub)
        return out
    out.update(sub)
    return out


def _forward_view(params: PyTree, group: StackedGroup, sub: PyTree) -> PyTree:
    """``params`` as the partial step's forward sees it: a stacked group's
    stack becomes a list of per-layer trees with ``sub`` in its slot, so
    the other layers stay views that do not require grad."""
    if group.index is None:
        return {**params, **sub}
    layers = _layers(params[group.key])
    layers[group.index] = sub
    return {**params, group.key: layers}


def make_fedpart_train_step(
    cfg: ModelConfig,
    group: StackedGroup,
    adam: AdamConfig = AdamConfig(),
    *,
    impl: str = "plain",
    remat: bool = True,
):
    """Partial step: grads and optimizer state only for ``group``.

    ``opt_state`` is over the group's subtree (1/M of full-model state)."""

    def train_step(params: PyTree, opt_state: AdamState, batch: dict):
        trainable = _select_group(params, group)
        loss, grads = loss_and_grads(cfg, params, batch, group, impl=impl, remat=remat)
        new_sub, new_state = adam_update(grads, opt_state, trainable, adam)
        with torch.no_grad():
            return _inject_group(params, group, new_sub), new_state, loss

    return train_step


def init_partial_opt_state(params: PyTree, group: StackedGroup) -> AdamState:
    return adam_init(_select_group(params, group))


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, *, window: int = 0, impl: str = "kernel"):
    def prefill_step(params, batch):
        logits, cache, _ = api.forward(params, cfg, batch, window=window, impl=impl,
                                       collect_cache=True)
        return logits[:, -1:, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, window: int = 0):
    def serve_step(params, token, cache, pos):
        return api.decode_step(params, cfg, token, cache, pos, window=window)

    return serve_step
