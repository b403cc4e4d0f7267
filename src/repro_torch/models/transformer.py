"""Decoder-only transformer (dense or MoE blocks, GQA or MLA attention, the
multi-token-prediction head), the xLSTM and the Zamba2 hybrid (port of
``repro.models.transformer``).

Parameters keep the reference's *stacked* layout: ``params["blocks"]``
holds every dense block's leaves with a leading layer axis,
``params["moe_blocks"]`` the MoE blocks' (DeepSeek-V3's leading
``first_dense_layers`` are dense, the rest MoE), ``params["mtp"]`` the
MTP head (``proj``, ``norm`` and one dense ``block``); the xLSTM's
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
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
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


# ---------------------------------------------------------------------------
# Decoder block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, device,
               n: int | None = None, *, use_moe: bool = False) -> PyTree:
    """One block's params (GQA or MLA attention; a dense MLP or, with
    ``use_moe``, the MoE layer), or ``n`` of them stacked on a leading
    axis."""
    dt = _dtype(cfg)
    p: PyTree = {
        "attn_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "mlp_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
    }
    if cfg.use_mla:
        p["attn"] = attn.mla_init(gen, cfg, dt, device, n)
    else:
        p["attn"] = attn.gqa_init(gen, cfg, dt, device, n)
    if use_moe:
        p["moe"] = moe_lib.moe_init(gen, cfg, dt, device, n)
    else:
        p["mlp"] = mlp_init(gen, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dt, device, n)
    return p


def block_forward(
    p: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int,
    impl: str,
    use_moe: bool = False,
) -> tuple[torch.Tensor, PyTree, torch.Tensor]:
    """Returns (x, the block's cache entries, its MoE aux loss or 0)."""
    h = norm_apply(cfg.norm_kind, p["attn_norm"], x)
    if cfg.use_mla:
        y, (c0, c1) = attn.mla_full(p["attn"], cfg, h, positions, window=window, impl=impl)
        kv = {"c_kv": c0, "k_rope": c1}
    else:
        y, (ck, cv) = attn.gqa_full(p["attn"], cfg, h, positions, window=window,
                                    impl=impl)
        kv = {"k": ck, "v": cv}
    x = x + y
    h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
    if use_moe:
        y, aux = moe_lib.moe_apply(p["moe"], cfg, h)
    else:
        y = mlp_apply(p["mlp"], cfg.mlp_kind, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, kv, aux


def block_decode(
    p: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: PyTree,
    pos: int,
    *,
    window: int,
    use_moe: bool = False,
) -> tuple[torch.Tensor, PyTree]:
    """One token through a block; its cache entries are written in place."""
    h = norm_apply(cfg.norm_kind, p["attn_norm"], x)
    if cfg.use_mla:
        y, (c0, c1) = attn.mla_decode(p["attn"], cfg, h, cache["c_kv"], cache["k_rope"],
                                      pos, window=window)
        new_cache = {"c_kv": c0, "k_rope": c1}
    else:
        y, (ck, cv) = attn.gqa_decode(p["attn"], cfg, h, cache["k"], cache["v"], pos,
                                      window=window)
        new_cache = {"k": ck, "v": cv}
    x = x + y
    h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
    if use_moe:
        y, _ = moe_lib.moe_apply(p["moe"], cfg, h)
    else:
        y = mlp_apply(p["mlp"], cfg.mlp_kind, h)
    return x + y, new_cache


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

def decoder_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(dense blocks, MoE blocks): an MoE config's first
    ``first_dense_layers`` blocks are dense, the rest MoE."""
    n_moe = cfg.num_layers - cfg.first_dense_layers if cfg.is_moe else 0
    return cfg.num_layers - n_moe, n_moe


def _stacks(cfg: ModelConfig) -> list[tuple[str, int, bool]]:
    """(params key, layers, use_moe) of each non-empty block stack, in
    forward order."""
    n_dense, n_moe = decoder_layout(cfg)
    return [(key, n, use_moe) for key, n, use_moe in
            (("blocks", n_dense, False), ("moe_blocks", n_moe, True)) if n > 0]


def decoder_init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    """Random params from ``gen`` (the reference's distributions; not its
    numbers), on ``device``."""
    _ported(cfg)
    dt = _dtype(cfg)
    params: PyTree = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
    }
    for key, n, use_moe in _stacks(cfg):
        params[key] = block_init(gen, cfg, device, n=n, use_moe=use_moe)
    if not cfg.tie_embeddings:
        params["head"] = linear_init(gen, cfg.d_model, cfg.vocab_size, dt, device)
    if cfg.mtp_depth > 0:   # deepseek-v3 multi-token prediction head
        params["mtp"] = {
            "proj": linear_init(gen, 2 * cfg.d_model, cfg.d_model, dt, device),
            "norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
            "block": block_init(gen, cfg, device),
        }
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


MTP_WEIGHT = 0.3   # deepseek-v3 MTP loss weight (lambda in the paper)


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

    Returns (logits, caches | None, aux_loss): the caches stacked per block
    stack, ``(L, B, S, Hkv, D)`` K/V or MLA's ``(L, B, S, kv_lora_rank)``
    ``c_kv`` and ``(L, B, S, rope)`` ``k_rope``; aux the MoE blocks' summed
    load-balance losses, plus, with ``labels`` and an ``mtp`` head,
    ``MTP_WEIGHT`` × the head's next-next-token loss.  ``window`` > 0
    applies sliding-window attention.  ``remat`` recomputes each block's
    activations in the backward.
    """
    _ported(cfg)
    x = _embed_inputs(params, cfg, tokens, media_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}

    for key, n, use_moe in _stacks(cfg):
        def body(p, x, use_moe=use_moe):
            return block_forward(p, cfg, x, positions, window=window, impl=impl,
                                 use_moe=use_moe)

        kvs = []
        for i in range(n):
            x, kv, aux = _call(body, remat, _layer(params[key], i), x)
            aux_total = aux_total + aux
            if collect_cache:
                kvs.append(kv)
        if collect_cache:
            caches[key] = _stack(kvs, (n,))

    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    if cfg.mtp_depth > 0 and "mtp" in params and labels is not None:
        # deepseek-v3 multi-token prediction (training aux objective):
        # combine position t's hidden state with the embedding of token t+1,
        # run one extra dense block, predict the t+1 position's label.
        st = tokens.shape[1]
        x_tok = x[:, -st:]                       # token positions (skip media)
        mtp = params["mtp"]
        nxt = embed(params["embed"], tokens[:, 1:], x_tok.dtype)
        h = torch.cat([x_tok[:, :-1], nxt], dim=-1)
        h = norm_apply(cfg.norm_kind, mtp["norm"], linear(mtp["proj"], h))
        h, _, _ = block_forward(mtp["block"], cfg, h, positions[:, : st - 1],
                                window=window, impl=impl)
        mtp_logits = _logits(params, cfg, h)
        aux_total = aux_total + MTP_WEIGHT * lm_loss(mtp_logits, labels[:, 1:])
    return logits, (caches if collect_cache else None), aux_total


def decoder_decode_step(
    params: PyTree,
    cfg: ModelConfig,
    token: torch.Tensor,       # (B, 1) int
    cache: PyTree,
    pos: int,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, PyTree]:
    """One-token serve step against the KV (or MLA latent) cache, which it
    updates in place (the returned cache is the same tensors)."""
    _ported(cfg)
    x = embed(params["embed"], token, _act_dtype(cfg))
    for key, n, use_moe in _stacks(cfg):
        for i in range(n):
            x, _ = block_decode(_layer(params[key], i), cfg, x, _layer(cache[key], i), pos,
                                window=window, use_moe=use_moe)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    return _logits(params, cfg, x), cache


def decoder_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                       device) -> PyTree:
    """Zero caches per block stack: K/V ``(L, B, W, Hkv, D)``, or MLA's
    latent ``c_kv (L, B, W, kv_lora_rank)`` and ``k_rope (L, B, W, rope)``."""
    _ported(cfg)
    if cfg.use_mla:
        widths = {"c_kv": (cfg.kv_lora_rank,), "k_rope": (cfg.qk_rope_head_dim,)}
    else:
        kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
        widths = {"k": kv, "v": kv}
    return {key: {name: torch.zeros((n, batch, cache_len) + w, dtype=dtype, device=device)
                  for name, w in widths.items()}
            for key, n, _ in _stacks(cfg)}


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
        y, kv, _ = block_forward(shared["block"], cfg, h, positions, window=window,
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
