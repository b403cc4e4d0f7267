"""Mixture-of-Experts layer: top-k router + capacity-bounded expert FFNs
(port of ``repro.models.moe``).

Dispatch is sort-based, as the reference's: each token's k (token, expert)
entries are ranked inside their expert by a stable argsort of the flat
expert ids, and scattered into a dense ``(E, C, d)`` buffer; entries past
an expert's capacity C go to a sentinel row that is discarded.  The expert
FFNs are three batched products over the expert axis (``torch.bmm`` →
cuBLAS), plain products the reference leaves to XLA, so no kernel of the
port's is on this path.

Where the port differs from the reference in form, not in value:

* **Top-k.** ``jax.lax.top_k`` puts the lower expert index first among
  equal scores; ``torch.topk`` promises no order among ties (bf16 router
  logits of 256 experts tie often).  ``_top_k`` takes the first k of a
  stable descending sort, which is the reference's rule.
* **Combine.** The reference scatter-adds the k weighted rows of each token
  into zeros (``.at[token_idx].add``); the entries are token-major, so the
  port sums a ``(T, k, d)`` view over k instead: no atomics, the same
  result run to run on the card.
* **Capacity** is Python integer arithmetic (``_capacity``), as the
  reference's.  At decode T = B, so the capacity is small (Llama-4 at B 4:
  1) and a second token routed to a busy expert is dropped, as in the
  reference.

``moe_dropless`` (DeepSeek-V2) takes ``moe_apply_dropless`` instead: no
capacity and no dropped entry, the sequence-wise balance loss, the layer
told which experts it holds (``experts_held``, ``first_expert``), the
expert products grouped products over the entries sorted by expert
(``kernels.grouped_mm``), with the group bounds on the device, so it runs
under ``torch.func.vmap`` (the vmap engine's cohort step) without a
read-back.

Each part runs under a profiler label (``PROFILE_LABELS``: the router,
the dispatch's sort / counts / scatter with the aux loss, the expert
products, the combine and the shared expert), so a profile can split an MoE layer's device time.

Under ``moe_ep.expert_parallel(mesh)`` ``moe_apply`` dispatches to
``moe_ep.moe_apply_ep`` (explicit expert parallelism over the mesh's
"model" axis on ``torch.distributed``), as the reference's does; both run
the same router (``route``) and sort dispatch (``dispatch``).  DTensor
tokens without it take ``_moe_apply_dtensor`` (GSPMD's partitioning of
the same layer).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig, experts_held, port_field
from repro_torch.kernels.grouped_mm import grouped_swiglu
from repro_torch.models.layers import _lead, linear_init, mlp_apply, mlp_init, normal_init
from repro_torch.tree import PyTree

# profiler labels of an MoE layer's parts, in the order they run
MOE_ROUTE = "moe_route"           # router GEMM, scores, top-k
MOE_DISPATCH = "moe_dispatch"     # argsort, counts, aux loss, ranks, scatter into (E, C, d)
                                  # (dropless: sort by expert, group ends)
MOE_EXPERTS = "moe_experts"       # the three batched expert GEMMs and SwiGLU (dropless: the
                                  # gather and grouped products, forward and backward)
MOE_COMBINE = "moe_combine"       # gather, gate weighting, sum over k
MOE_SHARED = "moe_shared"         # the shared expert's MLP
PROFILE_LABELS = (MOE_ROUTE, MOE_DISPATCH, MOE_EXPERTS, MOE_COMBINE, MOE_SHARED)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             n: int | None = None) -> PyTree:
    """The reference's leaves and shapes (``router/w (d, E)``,
    ``experts/{w_gate,w_up} (E, d, F)``, ``experts/w_down (E, F, d)``,
    ``shared`` an MLP of ``moe_d_ff × num_shared_experts``), or ``n`` of
    them stacked on a leading axis.  With ``experts_held`` the experts'
    leading axis holds only those (the router keeps all E)."""
    e, d, f = experts_held(cfg), cfg.d_model, cfg.moe_d_ff
    lead = _lead(n)
    p: PyTree = {
        "router": linear_init(gen, d, cfg.num_experts, dtype, device, n=n),
        "experts": {
            # drawn one expert at a time (``normal_init``): a whole f32 draw of
            # Llama-4's (128, 5,120, 8,192) would be 21.5 GB beside its 10.7 GB
            "w_gate": normal_init(gen, lead + (e, d, f), 1.0 / math.sqrt(d), dtype, device),
            "w_up": normal_init(gen, lead + (e, d, f), 1.0 / math.sqrt(d), dtype, device),
            "w_down": normal_init(gen, lead + (e, f, d), 1.0 / math.sqrt(f), dtype, device),
        },
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = mlp_init(gen, cfg.mlp_kind, d, f * cfg.num_shared_experts,
                               dtype, device, n)
    return p


def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    c = int(num_tokens * cfg.num_experts_per_tok * cfg.capacity_factor) // cfg.num_experts
    return max(c, 1)


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, largest first,
    the lower index first among equal scores."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: PyTree, cfg: ModelConfig,
          xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on flat tokens ``xf`` (T, d): returns the f32 logits
    (T, E), the top-k gate values (T, k) f32 and the chosen experts (T, k).
    Logits are computed in the activation dtype, then cast to f32, as the
    reference's.  The gate values are renormalised to sum 1 when
    ``norm_topk_prob`` (the reference's rule)."""
    logits = (xf @ params["router"]["w"].to(xf.dtype)).float()
    gate_vals, expert_idx = _top_k(_scores(cfg, logits), cfg.num_experts_per_tok)
    if port_field(cfg, "norm_topk_prob"):
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return logits, gate_vals, expert_idx


def _scores(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.router_score == "sigmoid":            # deepseek-v3
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def dispatch(cfg: ModelConfig, logits: torch.Tensor, expert_idx: torch.Tensor,
             cap: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sort dispatch of T tokens' (T, k) chosen experts: returns each
    (token, choice) entry's slot in the flat ``(E * cap + 1)`` buffer
    (token-major, (T*k,); ``E * cap`` is the dropped entries' sentinel), the
    entries' token ids and the load-balance auxiliary loss (Switch/GShard
    form, from the f32 ``logits``)."""
    t, k = expert_idx.shape
    e = cfg.num_experts
    dev = logits.device
    flat_expert = expert_idx.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    # each expert's start offset and count in the sorted entries (not
    # bincount: on the card it reads the largest id back to the host)
    bounds = torch.searchsorted(sorted_expert, torch.arange(e + 1, device=dev))
    start, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    # the softmax of the logits, whatever the router's scores
    probs_mean = torch.mean(torch.softmax(logits, dim=-1), dim=0)          # (E,)
    frac = counts.float() / (t * k)
    aux_loss = e * torch.sum(frac * probs_mean) * cfg.aux_loss_weight
    # rank within expert = index-in-sorted - start offset of that expert
    rank_sorted = torch.arange(t * k, device=dev) - start[sorted_expert]
    slot_sorted = torch.where(rank_sorted < cap, sorted_expert * cap + rank_sorted,
                              torch.full_like(rank_sorted, e * cap))      # dropped: sentinel
    slots = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    token_idx = torch.arange(t, device=dev).repeat_interleave(k)
    return slots, token_idx, aux_loss


def fill_slots(xf: torch.Tensor, slots: torch.Tensor, token_idx: torch.Tensor,
               e: int, cap: int, e0: int = 0, n_e: int | None = None) -> torch.Tensor:
    """The (n_e, C, d) slots of experts ``e0 .. e0 + n_e - 1`` (all ``e`` by
    default), each (token, choice) entry's token ``xf[token_idx]`` written to
    its slot; the many dropped entries write the sentinel row, which is
    discarded."""
    n_e = e if n_e is None else n_e
    d = xf.shape[-1]
    buf = torch.zeros(e * cap + 1, d, dtype=xf.dtype, device=xf.device).index_put(
        (slots,), xf[token_idx])
    return buf[e0 * cap: (e0 + n_e) * cap].reshape(n_e, cap, d)


def gate_sum(vals: torch.Tensor, gate_vals: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's gate-weighted sum of its k entries' (T*k, d) outputs."""
    weighted = vals * gate_vals.reshape(-1)[:, None].to(vals.dtype)      # (T*k, d)
    return weighted.reshape(-1, k, vals.shape[-1]).sum(dim=1)


def combine(expert_out: torch.Tensor, slots: torch.Tensor, gate_vals: torch.Tensor,
            k: int) -> torch.Tensor:
    """(E, C, d) expert outputs -> (T, d): each entry reads its slot (a
    dropped entry the zero sentinel row), weighted by its gate."""
    d = expert_out.shape[-1]
    out_buf = torch.cat([expert_out.reshape(-1, d),
                         expert_out.new_zeros(1, d)], dim=0)
    return gate_sum(out_buf[slots], gate_vals, k)


def experts_apply(ew: PyTree, expert_in: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert's (E, C, d) slots, batched over the expert axis."""
    dt = expert_in.dtype
    g = F.silu(torch.bmm(expert_in, ew["w_gate"].to(dt)))
    u = torch.bmm(expert_in, ew["w_up"].to(dt))
    return torch.bmm(g * u, ew["w_down"].to(dt))


def moe_apply(params: PyTree, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).

    Under ``moe_ep.expert_parallel(mesh)`` this dispatches to the explicit
    expert-parallel path (``moe_ep.moe_apply_ep``)."""
    from repro_torch.models import moe_ep

    if port_field(cfg, "moe_dropless"):
        return moe_apply_dropless(params, cfg, x)
    if experts_held(cfg) != cfg.num_experts:
        raise ValueError("experts_held takes the dropless layer (moe_dropless)")
    if moe_ep.ep_enabled():
        return moe_ep.moe_apply_ep(params, cfg, x)
    if isinstance(x, DTensor):
        return _moe_apply_dtensor(params, cfg, x)
    b, s, d = x.shape
    t = b * s
    k = cfg.num_experts_per_tok
    e = cfg.num_experts
    cap = _capacity(t, cfg)
    xf = x.reshape(t, d)
    with record_function(MOE_ROUTE):
        logits, gate_vals, expert_idx = route(params, cfg, xf)

    with record_function(MOE_DISPATCH):
        slots, token_idx, aux_loss = dispatch(cfg, logits, expert_idx, cap)
        expert_in = fill_slots(xf, slots, token_idx, e, cap)

    with record_function(MOE_EXPERTS):
        expert_out = experts_apply(params["experts"], expert_in)

    with record_function(MOE_COMBINE):
        y = combine(expert_out, slots, gate_vals, k)

    if cfg.num_shared_experts > 0:
        with record_function(MOE_SHARED):
            y = y + mlp_apply(params["shared"], cfg.mlp_kind, xf)
    return y.reshape(b, s, d), aux_loss


def seq_aux_loss(cfg: ModelConfig, scores: torch.Tensor,
                 expert_idx: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V2's sequence-wise balance loss of a (B, S) batch: per
    sequence, ``Σ_i f_i P_i`` with ``f_i`` the share of the sequence's S·k
    choices that went to expert i, times E / k, and ``P_i`` the sequence's
    mean score of expert i; averaged over the sequences, times
    ``aux_loss_weight``.  ``scores`` (B, S, E) f32, ``expert_idx`` (B, S, k).
    The counts are compared with every expert id, not one-hot encoded:
    ``F.one_hot`` reads the ids' range back to the host."""
    b, s, e = scores.shape
    k = expert_idx.shape[-1]
    chosen = expert_idx.reshape(b, s * k, 1) == torch.arange(e, device=scores.device)
    frac = chosen.sum(dim=1).float() / (s * k / e)                      # (B, E)
    return (frac * scores.mean(dim=1)).sum(dim=1).mean() * cfg.aux_loss_weight


def moe_apply_dropless(params: PyTree, cfg: ModelConfig,
                       x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V2's MoE layer: x: (B, S, d) -> (y, the sequence-wise balance
    loss), every (token, choice) entry computed.

    The router scores all ``num_experts`` experts and picks k; this layer
    holds experts ``first_expert .. first_expert + experts_held - 1`` and
    computes their part of the result, leaving out what the others would
    add (a chip's share under expert parallelism, without the exchange).
    Dispatch: the T·k entries are sorted by held expert (entries of other
    experts last), so each held expert's entries are one run of rows; the
    runs' ends stay on the device.  The expert products are grouped
    products over those runs (``kernels.grouped_mm.grouped_swiglu``: one
    launch a product for all the held experts, and under ``vmap`` for all
    the clients; it keeps only its inputs for the backward), over buffers of
    T·k rows, the most the held experts can get, so no size depends on the
    routing.  Combine: each entry's output, weighted by its gate (0 for an
    expert not held), summed over its token's k entries.  The shared
    experts run on every token.  Nothing is read back to the host."""
    b, s, d = x.shape
    t, k = b * s, cfg.num_experts_per_tok
    held = experts_held(cfg)
    xf = x.reshape(t, d)
    with record_function(MOE_ROUTE):
        logits, gate_vals, expert_idx = route(params, cfg, xf)
    with record_function(MOE_DISPATCH):
        aux_loss = seq_aux_loss(cfg, _scores(cfg, logits).reshape(b, s, -1),
                                expert_idx.reshape(b, s, k))
        local = expert_idx.reshape(-1) - cfg.first_expert                  # (T*k,)
        mine = (local >= 0) & (local < held)
        group = torch.where(mine, local, held)
        order = torch.argsort(group, stable=True)
        counts = (group[:, None] == torch.arange(held, device=x.device)).sum(dim=0)
        ends = torch.cumsum(counts, dim=0).to(torch.int32)
    with record_function(MOE_EXPERTS):
        ew = params["experts"]
        expert_out = grouped_swiglu(xf, order, ends, *(ew[n].to(xf.dtype) for n in
                                                        ("w_gate", "w_up", "w_down")), k)
    with record_function(MOE_COMBINE):
        gates = gate_vals * mine.reshape(t, k)
        y = gate_sum(expert_out[torch.argsort(order)], gates, k)
    if cfg.num_shared_experts > 0:
        with record_function(MOE_SHARED):
            y = y + mlp_apply(params["shared"], cfg.mlp_kind, xf)
    return y.reshape(b, s, d), aux_loss


def _moe_apply_dtensor(params: PyTree, cfg: ModelConfig,
                       x: DTensor) -> tuple[DTensor, DTensor]:
    """``moe_apply`` on DTensor tokens and params, as GSPMD partitions the
    reference's layer without expert parallelism: the capacity is the
    global token count's, and the router, the sort dispatch and the
    combine run on tokens **replicated on every rank** (an all-gather of
    the (T, d) tokens and, after the experts, of the (E, C, d) buffer:
    GSPMD replicates the sort dispatch's buffer the same way, which is why
    the reference wrote ``moe_ep``).  Only the three expert products are
    partitioned, by the experts' placements (experts over "model", d_model
    over "data" under FSDP).  The shared expert runs on the tokens as they
    are laid out, tensor-parallel by its own placements.  The sort, the
    ``searchsorted`` and the scatter have no DTensor sharding rules: they
    run through ``local_map`` on the replicated tensors, so every rank
    computes the same dispatch."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim      # a list: local_map reads a tuple as one per output
    b, s, d = x.shape
    t = b * s
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    cap = _capacity(t, cfg)
    xf = x.reshape(t, d)
    xr = xf.redistribute(mesh, rep)
    router_w = params["router"]["w"].redistribute(mesh, rep)

    def route_and_dispatch(xl, wl):
        logits, gate_vals, expert_idx = route({"router": {"w": wl}}, cfg, xl)
        slots, token_idx, aux = dispatch(cfg, logits, expert_idx, cap)
        return fill_slots(xl, slots, token_idx, e, cap), gate_vals, slots, aux

    with record_function(MOE_DISPATCH):
        expert_in, gate_vals, slots, aux = local_map(
            route_and_dispatch, out_placements=(rep,) * 4, in_placements=(rep, rep),
            device_mesh=mesh)(xr, router_w)
    with record_function(MOE_EXPERTS):
        expert_out = experts_apply(params["experts"], expert_in)
    with record_function(MOE_COMBINE):
        y = local_map(lambda out, sl, g: combine(out, sl, g, k), out_placements=rep,
                      in_placements=(rep,) * 3, device_mesh=mesh, redistribute_inputs=True)(
            expert_out, slots, gate_vals).reshape(b, s, d)
    if cfg.num_shared_experts > 0:
        # on the (B, S, d) tokens as they are laid out: the same rows' products
        with record_function(MOE_SHARED):
            y = y + mlp_apply(params["shared"], cfg.mlp_kind, x)
    return y, aux


def moe_flops_per_token(cfg: ModelConfig) -> int:
    """Active matmul FLOPs per token (routed top-k x capacity + shared)."""
    routed = 2 * 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts_per_tok
    shared = 2 * 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_shared_experts
    router = 2 * cfg.d_model * cfg.num_experts
    return int(routed * cfg.capacity_factor + shared + router)
