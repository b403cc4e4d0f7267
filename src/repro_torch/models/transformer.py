"""Decoder-only transformer, dense GQA blocks (port of the decoder part of
``repro.models.transformer``).

Parameters keep the reference's *stacked* layout: ``params["blocks"]``
holds every block's leaves with a leading ``num_layers`` axis, so the
reference's ``api.init`` params bridge across unchanged.  The reference's
``jax.lax.scan`` over that axis is a Python loop over layers here (PyTorch
runs eagerly; there is nothing to trace).

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP item:
MoE blocks, MLA, the multi-token-prediction head, the xLSTM and the Zamba2
hybrid assemblies.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, embedding_init, linear, linear_init,
                                       mlp_apply, mlp_init, norm_apply, norm_init,
                                       unembed)
from repro_torch.tree import PyTree, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.activation_dtype]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.kind != "decoder":
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet: ROADMAP Queue 1 item 15")
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE decoder blocks are not ported yet: ROADMAP Queue 1 item 15")
    if cfg.mtp_depth > 0:
        raise NotImplementedError(
            "the multi-token-prediction head is not ported yet: ROADMAP Queue 1 item 15")


# ---------------------------------------------------------------------------
# Decoder block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, device,
               n: int | None = None) -> PyTree:
    """One dense block's params, or ``n`` of them stacked on a leading axis."""
    dt = _dtype(cfg)
    return {
        "attn_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "mlp_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "attn": attn.gqa_init(gen, cfg, dt, device, n),
        "mlp": mlp_init(gen, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dt, device, n),
    }


def block_forward(
    p: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int,
    impl: str,
) -> tuple[torch.Tensor, PyTree]:
    h = norm_apply(cfg.norm_kind, p["attn_norm"], x)
    y, (ck, cv) = attn.gqa_full(p["attn"], cfg, h, positions, window=window, impl=impl)
    x = x + y
    h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
    return x + mlp_apply(p["mlp"], cfg.mlp_kind, h), {"k": ck, "v": cv}


def block_decode(
    p: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: PyTree,
    pos: int,
    *,
    window: int,
) -> tuple[torch.Tensor, PyTree]:
    h = norm_apply(cfg.norm_kind, p["attn_norm"], x)
    y, (ck, cv) = attn.gqa_decode(p["attn"], cfg, h, cache["k"], cache["v"], pos,
                                  window=window)
    x = x + y
    h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
    return x + mlp_apply(p["mlp"], cfg.mlp_kind, h), {"k": ck, "v": cv}


def _layer(stack: PyTree, i: int) -> PyTree:
    return tree_map(lambda a: a[i], stack)


# ---------------------------------------------------------------------------
# Decoder-only model
# ---------------------------------------------------------------------------

def decoder_init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    """Random params from ``gen`` (the reference's distributions; not its
    numbers), on ``device``."""
    _dense_only(cfg)
    dt = _dtype(cfg)
    params: PyTree = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
        "blocks": block_init(gen, cfg, device, n=cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        params["head"] = linear_init(gen, cfg.d_model, cfg.vocab_size, dt, device)
    return params


def _embed_inputs(params, cfg, tokens, media_embeds):
    x = embed(params["embed"], tokens, _act_dtype(cfg))
    if media_embeds is not None:
        x = torch.cat([media_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["head"], x.float())


def _check_params(params: PyTree) -> None:
    for key in ("moe_blocks", "mtp"):
        if key in params:
            raise NotImplementedError(
                f"params[{key!r}] is not ported yet: ROADMAP Queue 1 item 15")


def decoder_forward(
    params: PyTree,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    labels: torch.Tensor | None = None,
    media_embeds: torch.Tensor | None = None,
    window: int = 0,
    impl: str = "kernel",
    collect_cache: bool = False,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    """Full-sequence forward (prefill).

    Returns (logits, caches | None, aux_loss); the caches are stacked
    ``(L, B, S, Hkv, D)``.  ``window`` > 0 applies sliding-window attention.
    ``labels`` only feed the reference's MTP head, which is not ported.
    """
    _dense_only(cfg)
    _check_params(params)
    del labels
    x = _embed_inputs(params, cfg, tokens, media_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    kvs = []
    for i in range(cfg.num_layers):
        x, kv = block_forward(_layer(params["blocks"], i), cfg, x, positions,
                              window=window, impl=impl)
        if collect_cache:
            kvs.append(kv)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    caches = None
    if collect_cache:
        caches = {"blocks": {name: torch.stack([kv[name] for kv in kvs])
                             for name in ("k", "v")}}
    return logits, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def decoder_decode_step(
    params: PyTree,
    cfg: ModelConfig,
    token: torch.Tensor,       # (B, 1) int
    cache: PyTree,
    pos: int,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, PyTree]:
    """One-token serve step against the KV cache, which it updates in place
    (the returned cache is the same tensors)."""
    _dense_only(cfg)
    _check_params(params)
    x = embed(params["embed"], token, _act_dtype(cfg))
    stack = cache["blocks"]
    for i in range(cfg.num_layers):
        x, _ = block_decode(_layer(params["blocks"], i), cfg, x, _layer(stack, i), pos,
                            window=window)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    return _logits(params, cfg, x), cache


def decoder_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                       device) -> PyTree:
    _dense_only(cfg)
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, hd)
    return {"blocks": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross entropy.  logits: (B,S,V); labels: (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
