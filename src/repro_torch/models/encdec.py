"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The modality frontend (mel-spectrogram + conv feature extractor) is a stub,
as in the reference: the batch carries precomputed frame embeddings of
shape (B, encoder_seq, d_model) (``models/frontends.py``).  The backbone is
whole: a bidirectional encoder over learned positions, a causal decoder
with cross-attention into the encoder's output, pre-LayerNorm blocks, GELU
MLPs with biases, the decoder's embedding tied to its logits head.

Parameters keep the reference's stacked layout (``enc_blocks`` and
``dec_blocks`` hold every block's leaves on a leading layer axis), so the
reference's ``api.init`` params bridge across unchanged and
``launch.steps.list_groups`` yields the reference's groups.  The
reference's ``jax.lax.scan`` over a stack is a Python loop here, its
``remat`` ``torch.utils.checkpoint`` around each block
(``layers.maybe_remat``).

``impl`` picks all three attentions of a prefill: ``"kernel"`` sends the
encoder's self-attention (``causal=False``), the decoder's self-attention
(causal) and the cross-attention (``causal=False``, Sq the decoder's
length, Skv ``encoder_seq``) through the flash kernel; ``"plain"`` is the
reference's math op for op.  The reference's ``api.forward`` accepts
``impl`` and ignores it for this kind: the port routes the same function
through its kernel, as it does for the Mamba2 and mLSTM scans.  One-token
decode is plain, as in the reference, and writes the self-attention cache
in place (``attention.gqa_decode``); the cross caches are read only.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import sharded_heads
from repro_torch.models.layers import (act_dtype, embed, embedding_init, layer_slice, linear,
                                       maybe_remat, mlp_apply, mlp_init, norm_apply,
                                       norm_init, normal_init, param_dtype, stack_layers,
                                       unembed)
from repro_torch.tree import PyTree


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.encoder_layers or cfg.num_layers


def _enc_blocks_init(gen: torch.Generator, cfg: ModelConfig, device, n: int) -> PyTree:
    dt = param_dtype(cfg)
    return {
        "attn_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "attn": attn.gqa_init(gen, cfg, dt, device, n),
        "mlp_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "mlp": mlp_init(gen, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dt, device, n),
    }


def _dec_blocks_init(gen: torch.Generator, cfg: ModelConfig, device, n: int) -> PyTree:
    dt = param_dtype(cfg)
    return {
        "self_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "self_attn": attn.gqa_init(gen, cfg, dt, device, n),
        "cross_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "cross_attn": attn.gqa_init(gen, cfg, dt, device, n),
        "mlp_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device, n),
        "mlp": mlp_init(gen, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dt, device, n),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    """Random params from ``gen`` (the reference's distributions, not its
    numbers), on ``device``; the blocks stacked on a leading layer axis."""
    dt = param_dtype(cfg)
    return {
        "enc_pos": normal_init(gen, (cfg.encoder_seq, cfg.d_model), 0.01, dt, device),
        "enc_blocks": _enc_blocks_init(gen, cfg, device, _n_enc(cfg)),
        "enc_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "dec_pos": normal_init(gen, (max(cfg.max_position_embeddings, 8), cfg.d_model), 0.01,
                           dt, device),
        "dec_blocks": _dec_blocks_init(gen, cfg, device, cfg.num_layers),
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
    }


def _cross_attend(p: PyTree, cfg: ModelConfig, x: torch.Tensor, enc_k: torch.Tensor,
                  enc_v: torch.Tensor, impl: str = "plain") -> torch.Tensor:
    """Cross-attention: queries from the decoder stream, K/V from the
    encoder's output (computed once at prefill and cached), no mask."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = attn._split_heads(linear(p["wq"], x), cfg.num_heads, hd)
    y = attn._sdpa(q, enc_k, enc_v, None, impl=impl, causal=False)
    return linear(p["wo"], sharded_heads.merge_heads(y))


def _enc_kv(p: PyTree, cfg: ModelConfig,
            enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = attn._split_heads(linear(p["wk"], enc_out), cfg.num_kv_heads, hd)
    v = attn._split_heads(linear(p["wv"], enc_out), cfg.num_kv_heads, hd)
    return k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def encode(params: PyTree, cfg: ModelConfig, frames: torch.Tensor, *,
           impl: str = "kernel", remat: bool = False) -> torch.Tensor:
    """frames: (B, encoder_seq, d_model) stub embeddings -> the encoder's
    output, bidirectional self-attention in every block."""
    act = act_dtype(cfg)
    x = frames.to(act) + params["enc_pos"].to(act)[None]
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def body(p, x):
        h = norm_apply(cfg.norm_kind, p["attn_norm"], x)
        y, _ = attn.gqa_full(p["attn"], cfg, h, positions, causal=False, impl=impl)
        x = x + y
        h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
        return x + mlp_apply(p["mlp"], cfg.mlp_kind, h)

    for i in range(_n_enc(cfg)):
        x = maybe_remat(body, remat, layer_slice(params["enc_blocks"], i), x)
    return norm_apply(cfg.norm_kind, params["enc_norm"], x)


def encdec_forward(
    params: PyTree,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    frames: torch.Tensor,
    *,
    window: int = 0,
    impl: str = "kernel",
    collect_cache: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    """Teacher-forced decoder over stub audio-frame embeddings.

    Returns (logits, caches | None, aux = 0): f32 logits through the tied
    embedding; the caches ``self_k`` / ``self_v`` (L, B, S, Hkv, D) and
    ``cross_k`` / ``cross_v`` (L, B, encoder_seq, Hkv, D).  Decoder
    positions are taken modulo the ``dec_pos`` table's size, as the
    reference's, so sequences past 448 positions still run.
    """
    enc_out = encode(params, cfg, frames, impl=impl, remat=remat)
    x = embed(params["embed"], tokens, act_dtype(cfg))
    b, s, _ = x.shape
    table = params["dec_pos"].to(x.dtype)
    x = x + table[torch.arange(s, device=x.device) % table.shape[0]][None]
    positions = _positions(b, s, x.device)

    def body(p, x):
        h = norm_apply(cfg.norm_kind, p["self_norm"], x)
        y, (sk, sv) = attn.gqa_full(p["self_attn"], cfg, h, positions, window=window,
                                    impl=impl)
        x = x + y
        h = norm_apply(cfg.norm_kind, p["cross_norm"], x)
        ck, cv = _enc_kv(p["cross_attn"], cfg, enc_out)
        x = x + _cross_attend(p["cross_attn"], cfg, h, ck, cv, impl=impl)
        h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
        out = x + mlp_apply(p["mlp"], cfg.mlp_kind, h)
        return out, {"self_k": sk, "self_v": sv, "cross_k": ck, "cross_v": cv}

    caches = []
    for i in range(cfg.num_layers):
        x, c = maybe_remat(body, remat, layer_slice(params["dec_blocks"], i), x)
        if collect_cache:
            caches.append(c)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    logits = unembed(params["embed"], x)   # whisper ties the decoder's embeddings
    return (logits, stack_layers(caches, (cfg.num_layers,)) if collect_cache else None,
            torch.zeros((), dtype=torch.float32, device=x.device))


def encdec_decode_step(
    params: PyTree,
    cfg: ModelConfig,
    token: torch.Tensor,       # (B, 1) int
    cache: PyTree,
    pos: int,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, PyTree]:
    """One decoder token against the cached self K/V, written in place at
    ``pos`` (the returned cache is the same tensors), and the encoder's
    cross K/V."""
    x = embed(params["embed"], token, act_dtype(cfg))
    table = params["dec_pos"].to(x.dtype)
    x = x + table[pos % table.shape[0]][None, None]
    for i in range(cfg.num_layers):
        p, c = layer_slice(params["dec_blocks"], i), layer_slice(cache, i)
        h = norm_apply(cfg.norm_kind, p["self_norm"], x)
        y, _ = attn.gqa_decode(p["self_attn"], cfg, h, c["self_k"], c["self_v"], pos,
                               window=window)
        x = x + y
        h = norm_apply(cfg.norm_kind, p["cross_norm"], x)
        x = x + _cross_attend(p["cross_attn"], cfg, h, c["cross_k"], c["cross_v"])
        h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
        x = x + mlp_apply(p["mlp"], cfg.mlp_kind, h)
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    return unembed(params["embed"], x), cache


def encdec_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                      device) -> PyTree:
    """Zero caches: self K/V (L, B, cache_len, Hkv, D), cross K/V
    (L, B, encoder_seq, Hkv, D)."""
    kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
    lens = {"self_k": cache_len, "self_v": cache_len,
            "cross_k": cfg.encoder_seq, "cross_v": cfg.encoder_seq}
    return {name: torch.zeros((cfg.num_layers, batch, n) + kv, dtype=dtype, device=device)
            for name, n in lens.items()}
