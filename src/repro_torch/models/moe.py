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

Each part runs under a profiler label (``PROFILE_LABELS``: the router,
the dispatch's sort / counts / scatter with the aux loss, the expert
products, the combine and the shared expert), so a profile can split an MoE layer's device time.

The reference's ``moe_ep.ep_enabled()`` branch (explicit expert
parallelism over a device mesh) is not ported: ROADMAP Queue 1 item 15.5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _lead, linear_init, mlp_apply, mlp_init
from repro_torch.tree import PyTree

# profiler labels of an MoE layer's parts, in the order they run
MOE_ROUTE = "moe_route"           # router GEMM, scores, top-k
MOE_DISPATCH = "moe_dispatch"     # argsort, counts, aux loss, ranks, scatter into (E, C, d)
MOE_EXPERTS = "moe_experts"       # the three batched expert GEMMs and SwiGLU
MOE_COMBINE = "moe_combine"       # gather, gate weighting, sum over k
MOE_SHARED = "moe_shared"         # the shared expert's MLP
PROFILE_LABELS = (MOE_ROUTE, MOE_DISPATCH, MOE_EXPERTS, MOE_COMBINE, MOE_SHARED)


def _normal_per_expert(gen: torch.Generator, shape: tuple[int, ...], std: float,
                       dtype, device) -> torch.Tensor:
    """N(0, std²) of ``shape`` in ``dtype``, drawn one expert (the axis
    before the last two) at a time, so the f32 draw never holds more than
    one expert's matrix: an f32 copy of Llama-4's (128, 5,120, 8,192) would
    be 21.5 GB beside its 10.7 GB of bf16."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for sub in out.reshape(-1, *shape[-2:]):
        sub.copy_(torch.randn(shape[-2:], generator=gen, device=device,
                              dtype=torch.float32).mul_(std))
    return out


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             n: int | None = None) -> PyTree:
    """The reference's leaves and shapes (``router/w (d, E)``,
    ``experts/{w_gate,w_up} (E, d, F)``, ``experts/w_down (E, F, d)``,
    ``shared`` an MLP of ``moe_d_ff × num_shared_experts``), or ``n`` of
    them stacked on a leading axis."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    lead = _lead(n)
    p: PyTree = {
        "router": linear_init(gen, d, e, dtype, device, n=n),
        "experts": {
            "w_gate": _normal_per_expert(gen, lead + (e, d, f), 1.0 / math.sqrt(d),
                                         dtype, device),
            "w_up": _normal_per_expert(gen, lead + (e, d, f), 1.0 / math.sqrt(d),
                                       dtype, device),
            "w_down": _normal_per_expert(gen, lead + (e, f, d), 1.0 / math.sqrt(f),
                                         dtype, device),
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
    (T, E), the renormalised top-k gate values (T, k) f32 and the chosen
    experts (T, k).  Logits are computed in the activation dtype, then cast
    to f32, as the reference's."""
    logits = (xf @ params["router"]["w"].to(xf.dtype)).float()
    if cfg.router_score == "sigmoid":            # deepseek-v3
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(scores, cfg.num_experts_per_tok)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return logits, gate_vals, expert_idx


def moe_apply(params: PyTree, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    k = cfg.num_experts_per_tok
    e = cfg.num_experts
    cap = _capacity(t, cfg)
    dt = x.dtype
    xf = x.reshape(t, d)
    with record_function(MOE_ROUTE):
        logits, gate_vals, expert_idx = route(params, cfg, xf)

    with record_function(MOE_DISPATCH):
        flat_expert = expert_idx.reshape(-1)                               # (T*k,)
        order = torch.argsort(flat_expert, stable=True)
        sorted_expert = flat_expert[order]
        # each expert's start offset and count in the sorted entries (not
        # bincount: on the card it reads the largest id back to the host)
        bounds = torch.searchsorted(sorted_expert,
                                    torch.arange(e + 1, device=x.device))
        start, counts = bounds[:-1], bounds[1:] - bounds[:-1]
        # load-balance auxiliary loss (Switch/GShard form): the softmax of
        # the logits, whatever the router's scores
        probs_mean = torch.mean(torch.softmax(logits, dim=-1), dim=0)      # (E,)
        frac = counts.float() / (t * k)
        aux_loss = e * torch.sum(frac * probs_mean) * cfg.aux_loss_weight
        # rank within expert = index-in-sorted - start offset of that expert
        rank_sorted = torch.arange(t * k, device=x.device) - start[sorted_expert]
        slot_sorted = torch.where(rank_sorted < cap, sorted_expert * cap + rank_sorted,
                                  torch.full_like(rank_sorted, e * cap))  # dropped: sentinel
        slots = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
        token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
        # many dropped entries write the sentinel row; it is discarded
        buf = torch.zeros(e * cap + 1, d, dtype=dt, device=x.device).index_put(
            (slots,), xf[token_idx])
        expert_in = buf[: e * cap].reshape(e, cap, d)

    with record_function(MOE_EXPERTS):   # SwiGLU, batched over the expert axis
        ew = params["experts"]
        g = F.silu(torch.bmm(expert_in, ew["w_gate"].to(dt)))
        u = torch.bmm(expert_in, ew["w_up"].to(dt))
        expert_out = torch.bmm(g * u, ew["w_down"].to(dt))

    with record_function(MOE_COMBINE):
        out_buf = torch.cat([expert_out.reshape(e * cap, d),
                             torch.zeros(1, d, dtype=dt, device=x.device)], dim=0)
        weighted = out_buf[slots] * gate_vals.reshape(-1)[:, None].to(dt)  # (T*k, d)
        y = weighted.reshape(t, k, d).sum(dim=1)

    if cfg.num_shared_experts > 0:
        with record_function(MOE_SHARED):
            y = y + mlp_apply(params["shared"], cfg.mlp_kind, xf)
    return y.reshape(b, s, d), aux_loss


def moe_flops_per_token(cfg: ModelConfig) -> int:
    """Active matmul FLOPs per token (routed top-k x capacity + shared)."""
    routed = 2 * 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts_per_tok
    shared = 2 * 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_shared_experts
    router = 2 * cfg.d_model * cfg.num_experts
    return int(routed * cfg.capacity_factor + shared + router)
