"""Decoder-only transformer with dense GQA blocks, the xLSTM and the
Zamba2 hybrid (port of the decoder, xLSTM and hybrid parts of
``repro.models.transformer``).

Parameters keep the reference's *stacked* layout: ``params["blocks"]``
holds every block's leaves with a leading ``num_layers`` axis; the xLSTM's
``params["pairs"]`` its (mLSTM, sLSTM) pairs on one axis; the hybrid's
``params["chunks"]`` holds its Mamba2 blocks on ``(n_chunks, attn_every)``
axes and ``params["tail"]`` the leftover ones on one axis.  So the
reference's ``api.init`` params bridge across unchanged.  The reference's
``jax.lax.scan`` over those axes is a Python loop here (PyTorch runs
eagerly; there is nothing to trace), and its ``remat`` (``jax.checkpoint``
around the scan body) is ``torch.utils.checkpoint`` around each iteration
of that loop: a decoder block, an xLSTM pair, a hybrid chunk (shared block
+ its Mamba2 blocks), a tail Mamba2 block.  A forward may also be handed a stack as a
list of per-layer trees (``_layer``): the partial train step does, so that
only the trained layer's tensors require grad.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP item:
MoE blocks, MLA, the multi-token-prediction head.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (embed, embedding_init, linear, linear_init,
                                       mlp_apply, mlp_init, norm_apply, norm_init,
                                       unembed)
from repro_torch.tree import PyTree, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.activation_dtype]


def _ported(cfg: ModelConfig) -> None:
    """Raises for what the port does not run yet."""
    if cfg.kind not in ("decoder", "xlstm", "hybrid"):
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


def _layer(stack: PyTree | list[PyTree], i: int) -> PyTree:
    """Layer ``i`` of a stack: the ``[i]`` slices of a stacked tree, or item
    ``i`` of a list of per-layer trees."""
    if isinstance(stack, list):
        return stack[i]
    return tree_map(lambda a: a[i], stack)


def _call(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` its activations are recomputed in the
    backward instead of kept (non-reentrant ``torch.utils.checkpoint``; the
    recomputation repeats the same ops, so values and gradients are
    unchanged)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stack(trees: list[PyTree], lead: tuple[int, ...]) -> PyTree:
    """Stack same-structure trees on new leading axes ``lead``."""
    return tree_map(lambda *xs: torch.stack(xs).reshape(*lead, *xs[0].shape), *trees)


# ---------------------------------------------------------------------------
# Decoder-only model
# ---------------------------------------------------------------------------

def decoder_init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    """Random params from ``gen`` (the reference's distributions; not its
    numbers), on ``device``."""
    _ported(cfg)
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
    remat: bool = False,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    """Full-sequence forward (prefill, or the training loss's forward).

    Returns (logits, caches | None, aux_loss); the caches are stacked
    ``(L, B, S, Hkv, D)``.  ``window`` > 0 applies sliding-window attention.
    ``labels`` only feed the reference's MTP head, which is not ported.
    ``remat`` recomputes each block's activations in the backward.
    """
    _ported(cfg)
    _check_params(params)
    del labels
    x = _embed_inputs(params, cfg, tokens, media_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)

    def body(p, x):
        return block_forward(p, cfg, x, positions, window=window, impl=impl)

    kvs = []
    for i in range(cfg.num_layers):
        x, kv = _call(body, remat, _layer(params["blocks"], i), x)
        if collect_cache:
            kvs.append(kv)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    caches = {"blocks": _stack(kvs, (cfg.num_layers,))} if collect_cache else None
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
    _ported(cfg)
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
    _ported(cfg)
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, hd)
    return {"blocks": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ---------------------------------------------------------------------------
# xLSTM model (alternating mLSTM / sLSTM pairs)
# ---------------------------------------------------------------------------

def _n_pairs(cfg: ModelConfig) -> int:
    if cfg.num_layers % 2:
        raise ValueError(f"the xLSTM assembly uses mLSTM / sLSTM pairs: "
                         f"num_layers {cfg.num_layers} is odd")
    return cfg.num_layers // 2


def xlstm_init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    """Random params from ``gen`` (the reference's distributions), on
    ``device``; the pairs stacked on one leading axis."""
    _ported(cfg)
    dt = _dtype(cfg)
    n = _n_pairs(cfg)
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "pairs": {
            "m_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
            "mlstm": ssm.mlstm_init(gen, cfg, dt, device, n),
            "s_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
            "slstm": ssm.slstm_init(gen, cfg, dt, device, n),
        },
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
        "head": linear_init(gen, cfg.d_model, cfg.vocab_size, dt, device),
    }


def xlstm_forward(
    params: PyTree,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    impl: str = "kernel",
    collect_cache: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    """Full-sequence forward (prefill, or the training loss's forward);
    ``impl`` picks every mLSTM scan: the CUDA SSD-chunk kernel (two
    launches a pair: values and normaliser) or plain PyTorch.  ``remat``
    recomputes each pair's activations in the backward.

    Returns (logits, caches | None, aux_loss); the caches keep the
    reference's stacked layout: ``mlstm/{state,n_state}`` (pairs, B, H, P,
    ·) and ``slstm`` the tuple (c, n, h, m) of (pairs, B, heads, hdim).
    """
    _ported(cfg)
    x = embed(params["embed"], tokens, _act_dtype(cfg))

    def pair(p, x):
        h, m_cache = ssm.mlstm_forward(p["mlstm"], cfg,
                                       norm_apply(cfg.norm_kind, p["m_norm"], x), impl=impl)
        x = x + h
        h, s_cache = ssm.slstm_forward(p["slstm"], cfg,
                                       norm_apply(cfg.norm_kind, p["s_norm"], x))
        return x + h, {"mlstm": m_cache, "slstm": s_cache}

    n = _n_pairs(cfg)
    caches = []
    for i in range(n):
        x, c = _call(pair, remat, _layer(params["pairs"], i), x)
        if collect_cache:
            caches.append(c)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    return (logits, _stack(caches, (n,)) if collect_cache else None,
            torch.zeros((), dtype=torch.float32, device=x.device))


def xlstm_decode_step(
    params: PyTree,
    cfg: ModelConfig,
    token: torch.Tensor,       # (B, 1) int
    cache: PyTree,
    pos: int,
) -> tuple[torch.Tensor, PyTree]:
    """One-token serve step; writes each pair's new mLSTM states and sLSTM
    (c, n, h, m) into ``cache`` in place (the returned cache is the same
    tensors).  ``pos`` is unused: the recurrent state carries it."""
    _ported(cfg)
    del pos
    x = embed(params["embed"], token, _act_dtype(cfg))
    for i in range(_n_pairs(cfg)):
        p, c = _layer(params["pairs"], i), _layer(cache, i)
        h, mc = ssm.mlstm_decode(p["mlstm"], cfg, norm_apply(cfg.norm_kind, p["m_norm"], x),
                                 c["mlstm"])
        x = x + h
        h, sc = ssm.slstm_decode(p["slstm"], cfg, norm_apply(cfg.norm_kind, p["s_norm"], x),
                                 c["slstm"])
        x = x + h
        tree_map(lambda dst, src: dst.copy_(src), c, {"mlstm": mc, "slstm": sc})
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    return _logits(params, cfg, x), cache


def xlstm_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> PyTree:
    """A fresh cache, the pairs stacked: mLSTM states zero in ``dtype``,
    the sLSTM's (c, n, h) zero in ``dtype`` and m at ``ssm.M_INIT`` in f32."""
    _ported(cfg)
    n = _n_pairs(cfg)
    return {"mlstm": ssm.mlstm_cache_init(cfg, batch, dtype, device, n),
            "slstm": ssm.slstm_cache_init(cfg, batch, dtype, device, n)}


# ---------------------------------------------------------------------------
# Zamba2 hybrid (Mamba2 chunks + one shared attention block)
# ---------------------------------------------------------------------------

def hybrid_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(num_chunks, tail) — ``num_chunks`` groups of ``attn_every`` mamba
    blocks, each preceded by the shared attention block; ``tail`` leftover
    mamba blocks."""
    per = max(cfg.attn_every, 1)
    return cfg.num_layers // per, cfg.num_layers % per


def _mamba_layers_init(gen, cfg: ModelConfig, device, n) -> PyTree:
    dt = _dtype(cfg)
    return {"norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
            "mamba": ssm.mamba2_init(gen, cfg, dt, device, n)}


def hybrid_init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    """Random params from ``gen`` (the reference's distributions), on
    ``device``; ``"tail"`` only when there are leftover mamba blocks."""
    _ported(cfg)
    dt = _dtype(cfg)
    n_chunks, tail = hybrid_layout(cfg)
    params: PyTree = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "chunks": _mamba_layers_init(gen, cfg, device, (n_chunks, max(cfg.attn_every, 1))),
        "shared_attn": {
            # zamba2: the shared block consumes concat(hidden, original embedding)
            "in_proj": linear_init(gen, 2 * cfg.d_model, cfg.d_model, dt, device),
            "block": block_init(gen, cfg, device),
        },
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
        "head": linear_init(gen, cfg.d_model, cfg.vocab_size, dt, device),
    }
    if tail > 0:
        params["tail"] = _mamba_layers_init(gen, cfg, device, tail)
    return params


def hybrid_forward(
    params: PyTree,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    window: int = 0,
    impl: str = "kernel",
    collect_cache: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    """Full-sequence forward (prefill, or the training loss's forward);
    ``impl`` picks the shared block's attention and every Mamba2 scan: the
    CUDA kernels or plain PyTorch.  ``remat`` recomputes each chunk's and
    each tail block's activations in the backward, the reference's units.

    Returns (logits, caches | None, aux_loss).  The caches keep the
    reference's stacked layout: ``chunks/attn_kv/{k,v}`` (n_chunks, B, S,
    Hkv, D), ``chunks/mamba/{state,conv}`` (n_chunks, attn_every, B, ...),
    ``tail/{state,conv}`` (tail, B, ...) where the model has a tail.
    """
    _ported(cfg)
    x = embed(params["embed"], tokens, _act_dtype(cfg))
    x0 = x
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    n_chunks, tail = hybrid_layout(cfg)
    per = max(cfg.attn_every, 1)
    shared = params["shared_attn"]
    kvs, chunk_mc, tail_mc = [], [], []

    def mamba(p, x):
        y, c = ssm.mamba2_forward(p["mamba"], cfg, norm_apply(cfg.norm_kind, p["norm"], x),
                                  impl=impl)
        return x + y, c

    def chunk_body(chunk, x):
        h = linear(shared["in_proj"], torch.cat([x, x0], dim=-1))
        y, kv = block_forward(shared["block"], cfg, h, positions, window=window,
                              impl=impl)
        x = x + y
        mcs = []
        for j in range(per):
            x, mc = mamba(_layer(chunk, j), x)
            mcs.append(mc)
        return x, kv, mcs

    for c in range(n_chunks):
        x, kv, mcs = _call(chunk_body, remat, _layer(params["chunks"], c), x)
        if collect_cache:
            chunk_mc.extend(mcs)
            kvs.append(kv)
    for j in range(tail):
        x, mc = _call(mamba, remat, _layer(params["tail"], j), x)
        if collect_cache:
            tail_mc.append(mc)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    caches = None
    if collect_cache:
        caches = {"chunks": {"attn_kv": _stack(kvs, (n_chunks,)),
                             "mamba": _stack(chunk_mc, (n_chunks, per))}}
        if tail > 0:
            caches["tail"] = _stack(tail_mc, (tail,))
    return logits, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def _mamba_decode_into(p: PyTree, cfg: ModelConfig, x: torch.Tensor,
                       cache: PyTree) -> torch.Tensor:
    """One Mamba2 decode step; its new state and conv tail are written into
    ``cache`` (views of the stacked cache)."""
    y, new = ssm.mamba2_decode(p["mamba"], cfg, norm_apply(cfg.norm_kind, p["norm"], x),
                               cache)
    cache["state"].copy_(new["state"])
    cache["conv"].copy_(new["conv"])
    return x + y


def hybrid_decode_step(
    params: PyTree,
    cfg: ModelConfig,
    token: torch.Tensor,       # (B, 1) int
    cache: PyTree,
    pos: int,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, PyTree]:
    """One-token serve step; updates the KV caches and the Mamba2 states in
    place (the returned cache is the same tensors)."""
    _ported(cfg)
    x = embed(params["embed"], token, _act_dtype(cfg))
    x0 = x
    n_chunks, tail = hybrid_layout(cfg)
    per = max(cfg.attn_every, 1)
    shared = params["shared_attn"]
    for c in range(n_chunks):
        h = linear(shared["in_proj"], torch.cat([x, x0], dim=-1))
        y, _ = block_decode(shared["block"], cfg, h, _layer(cache["chunks"]["attn_kv"], c),
                            pos, window=window)
        x = x + y
        chunk, mcache = _layer(params["chunks"], c), _layer(cache["chunks"]["mamba"], c)
        for j in range(per):
            x = _mamba_decode_into(_layer(chunk, j), cfg, x, _layer(mcache, j))
    for j in range(tail):
        x = _mamba_decode_into(_layer(params["tail"], j), cfg, x, _layer(cache["tail"], j))
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    return _logits(params, cfg, x), cache


def hybrid_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                      device) -> PyTree:
    _ported(cfg)
    n_chunks, tail = hybrid_layout(cfg)
    per = max(cfg.attn_every, 1)
    shape = (n_chunks, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache: PyTree = {"chunks": {
        "attn_kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)},
        "mamba": ssm.mamba2_cache_init(cfg, batch, dtype, device, (n_chunks, per))}}
    if tail > 0:
        cache["tail"] = ssm.mamba2_cache_init(cfg, batch, dtype, device, tail)
    return cache


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
