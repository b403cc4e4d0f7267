"""Step functions of the launchers (port of ``repro.launch.steps``).

- ``make_train_step``          — FNU baseline: full-network Adam step.
- ``make_fedpart_train_step``  — the paper's technique on a served
  architecture: gradients and optimizer state restricted to one layer group
  (a layer of a stacked key such as ``blocks`` or the xLSTM's ``pairs``, or
  the ``embed`` / ``shared_attn`` / ``final_norm|head`` subtrees).
- ``make_prefill_step``        — full-sequence forward + KV cache write.
- ``make_serve_step``          — one-token decode against the cache.
- ``make_sharded_train_step`` / ``make_sharded_prefill_step`` /
  ``make_sharded_serve_step`` — the same three steps with every leaf a
  DTensor on a ``("data", "model")`` mesh (the reference's ``jax.jit`` with
  ``in_shardings`` / ``out_shardings``, ``launch/dryrun.py``
  ``compile_step``), placed by ``launch/sharding.py`` (``shard_params``,
  ``shard_inputs``, ``shard_opt_state``) and propagated through the model
  code, as GSPMD partitions the reference's.

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

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding
from repro_torch.models import act_sharding, api, moe_ep
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.tree import PyTree, tree_leaves, tree_map, tree_map_with_path

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


# ---------------------------------------------------------------------------
# Sharded steps (DTensor leaves on a ("data", "model") mesh)
# ---------------------------------------------------------------------------
#
# The counterpart of the reference's ``compile_step``: the params placed by
# ``sharding.shard_params`` (FSDP as the caller decides, ``dryrun._fsdp``),
# the f32 Adam state by the params' placements, the batch, token and cache
# by ``sharding.input_shardings``.  The model code runs on the DTensors
# under ``implicit_replication`` (positions, masks and other tensors built
# from shapes are replicated); the attention and the scans run on each
# rank's heads (``models.sharded_heads``), the MoE layers as
# ``moe._moe_apply_dtensor`` says or, with ``moe_ep``, through
# ``moe_ep.expert_parallel``.  Outputs keep the reference's
# ``out_shardings``: params and optimizer state their input placements,
# the train loss and the decode logits replicated, the caches
# ``sharding.cache_spec``'s.  A leaf that propagation left elsewhere is
# redistributed to it, and the step records its path in ``redistributed``;
# the gradient is brought to its param's layout before the update (the
# data-parallel all-reduce, or FSDP's reduce-scatter, that GSPMD inserts).


def _replicated(mesh) -> list:
    return [Replicate()] * mesh.ndim


def shard_inputs(batch: dict, mesh) -> dict:
    """``batch`` (a train / prefill batch, or a decode step's token and
    cache) as DTensors placed by ``sharding.input_shardings``: every rank
    passes the same full tensors and keeps its shards; a non-tensor leaf (a
    decode's ``pos``) passes through."""
    pl = sharding.input_shardings(batch, mesh)
    return tree_map_with_path(
        lambda p, x: distribute_tensor(x, mesh, pl[p], src_data_rank=None)
        if isinstance(x, torch.Tensor) else x, batch)


def shard_opt_state(state: AdamState, params: PyTree) -> AdamState:
    """An Adam state of plain tensors placed as the DTensor ``params`` it
    tracks (a FedPart step's: the group's subtree): ``m`` and ``v`` each
    as its param, the step count replicated."""
    mesh = tree_leaves(params)[0].device_mesh

    def like(x, p):
        return distribute_tensor(x, mesh, p.placements, src_data_rank=None)

    return AdamState(step=distribute_tensor(state.step, mesh, _replicated(mesh),
                                            src_data_rank=None),
                     m=tree_map(like, state.m, params), v=tree_map(like, state.v, params))


@contextlib.contextmanager
def sharded_context(cfg: ModelConfig, mesh, *, fsdp: bool = False, use_moe_ep: bool = False,
                    act_shard: bool = False):
    """What a sharded step runs under: ``implicit_replication``, expert
    parallelism for an MoE config with ``use_moe_ep`` (yields its
    ``ExpertParallel``, else None) and the activation layouts with
    ``act_shard``."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(implicit_replication())
        ep = (stack.enter_context(moe_ep.expert_parallel(mesh, fsdp))
              if use_moe_ep and cfg.is_moe else None)
        if act_shard:
            stack.enter_context(act_sharding.activation_sharding(mesh))
        yield ep


def _relayout(x, placements, path: str, moved: list):
    """``x`` in ``placements``, recording ``path`` in ``moved`` when it had
    to be redistributed."""
    if (not isinstance(x, DTensor) or placements is None
            or tuple(x.placements) == tuple(placements)):
        return x
    moved.append(path)
    return x.redistribute(x.device_mesh, placements)


def _keep_layout(tree: PyTree, like: PyTree, moved: list, prefix: str = "") -> PyTree:
    """``tree`` with every leaf in the placements of its ``like`` leaf."""
    return tree_map_with_path(
        lambda p, x, ref: _relayout(x, ref.placements, prefix + p, moved), tree, like)


def reduce_grads(grads: PyTree, params: PyTree) -> PyTree:
    """Each DTensor gradient in its param's placements: the reduction GSPMD
    inserts before the update (a partial sum over "data" all-reduced, or
    reduce-scattered where FSDP shards the param there)."""
    return tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                    if isinstance(g, DTensor) else g, grads, params)


def _micro(x: DTensor, i: int, accum: int) -> DTensor:
    """Microbatch ``i`` of ``accum``: the ``i``-th block of each rank's local
    batch rows, so every microbatch stays sharded as the batch is, with no
    collective (the microbatches' mean loss and gradient are the whole
    batch's)."""
    loc = x.to_local()
    n = loc.shape[0] // accum
    return DTensor.from_local(loc[i * n:(i + 1) * n], x.device_mesh, x.placements,
                              run_check=False)


def make_sharded_train_step(cfg: ModelConfig, mesh, adam: AdamConfig = AdamConfig(), *,
                            group: StackedGroup | None = None, fsdp: bool = False,
                            use_moe_ep: bool = False, act_shard: bool = False,
                            impl: str = "plain", remat: bool = True, accum: int = 1):
    """The FNU step (``group`` None) or the FedPart step of ``group`` on
    DTensor params, Adam state (``shard_opt_state``; a FedPart step's over
    the group) and batch (``shard_inputs``).  Returns (params, state, loss):
    params and state in their input placements, the loss replicated.
    ``accum`` > 1 averages the gradients of ``accum`` microbatches
    (``_micro``) in f32, as ``make_train_step``.  The step's
    ``redistributed`` lists the outputs it had to re-lay out in its last
    call, ``traffic`` expert parallelism's records."""

    def train_step(params, opt_state, batch):
        moved: list = []
        trainable = params if group is None else _select_group(params, group)
        with sharded_context(cfg, mesh, fsdp=fsdp, use_moe_ep=use_moe_ep,
                             act_shard=act_shard) as ep:
            loss, grads = None, None
            for i in range(accum):
                mb = batch if accum == 1 else tree_map(lambda x: _micro(x, i, accum), batch)
                lv, g = loss_and_grads(cfg, params, mb, group, impl=impl, remat=remat)
                if accum == 1:
                    loss, grads = lv, g
                elif grads is None:
                    loss, grads = lv, tree_map(lambda t: t.float(), g)
                else:
                    loss, grads = loss + lv, tree_map(torch.add, grads, g)
            if accum > 1:
                loss, grads = loss / accum, tree_map(lambda t: t / accum, grads)
            grads = reduce_grads(grads, trainable)
            new_sub, new_state = adam_update(grads, opt_state, trainable, adam)
            with torch.no_grad():
                new_params = (new_sub if group is None
                              else _inject_group(params, group, new_sub))
        new_params = _keep_layout(new_params, params, moved)
        new_state = AdamState(
            step=_relayout(new_state.step, getattr(opt_state.step, "placements", None),
                           "step", moved),
            m=_keep_layout(new_state.m, opt_state.m, moved, "m/"),
            v=_keep_layout(new_state.v, opt_state.v, moved, "v/"))
        loss = _relayout(loss, _replicated(mesh), "loss", [])
        train_step.redistributed = moved
        train_step.traffic = ep.traffic if ep is not None else []
        return new_params, new_state, loss

    train_step.redistributed, train_step.traffic = [], []
    return train_step


def make_sharded_prefill_step(cfg: ModelConfig, mesh, *, window: int = 0,
                              impl: str = "kernel", fsdp: bool = False,
                              use_moe_ep: bool = False, act_shard: bool = False):
    """``make_prefill_step`` on DTensor params and batch: returns (the last
    position's logits, the cache), the cache in ``sharding.cache_spec``'s
    placements.  ``impl="kernel"`` launches the flash and SSD kernels on
    each rank's heads."""
    inner = make_prefill_step(cfg, window=window, impl=impl)

    def prefill_step(params, batch):
        moved: list = []
        with sharded_context(cfg, mesh, fsdp=fsdp, use_moe_ep=use_moe_ep,
                             act_shard=act_shard) as ep:
            logits, cache = inner(params, batch)
        cache = tree_map_with_path(
            lambda p, x: _relayout(x, sharding.placements(
                sharding.cache_spec(tuple(x.shape), mesh), mesh), "cache/" + p, moved),
            cache)
        prefill_step.redistributed = moved
        prefill_step.traffic = ep.traffic if ep is not None else []
        return logits, cache

    prefill_step.redistributed, prefill_step.traffic = [], []
    return prefill_step


def make_sharded_serve_step(cfg: ModelConfig, mesh, *, window: int = 0, fsdp: bool = False,
                            use_moe_ep: bool = False, act_shard: bool = False):
    """``make_serve_step`` on DTensor params, token and cache: the cache is
    written in place and keeps its placements; the logits come back
    replicated (the reference's ``out_shardings``)."""

    def serve_step(params, token, cache, pos):
        moved: list = []
        like = tree_map(lambda x: x.placements, cache)
        with sharded_context(cfg, mesh, fsdp=fsdp, use_moe_ep=use_moe_ep,
                             act_shard=act_shard) as ep:
            logits, new_cache = api.decode_step(params, cfg, token, cache, pos,
                                                window=window)
        new_cache = tree_map_with_path(
            lambda p, x, pl: _relayout(x, pl, "cache/" + p, moved), new_cache, like)
        serve_step.redistributed = moved
        serve_step.traffic = ep.traffic if ep is not None else []
        return _relayout(logits, _replicated(mesh), "logits", []), new_cache

    serve_step.redistributed, serve_step.traffic = [], []
    return serve_step
