"""Unified model API, decoder and hybrid dispatch (port of
``repro.models.api``).

    init(gen, cfg, device)                          -> params
    forward(params, cfg, batch, ...)                -> (logits, cache|None, aux)
    loss(params, cfg, batch, ...)                   -> scalar training loss
    decode_step(params, cfg, token, cache, pos)     -> (logits, cache)
    cache_init(cfg, batch, cache_len, dtype, device) -> cache
    synth_batch(gen, cfg, shape, device)            -> batch

``kind == "decoder"`` (dense GQA), ``kind == "xlstm"`` (mLSTM / sLSTM
pairs) and ``kind == "hybrid"`` (Zamba2) are ported; ``encdec`` raises
``NotImplementedError`` naming its ROADMAP item.  Randomness comes from an explicit ``torch.Generator`` (the
reference's distributions, not its numbers: tests bridge the reference's
params and batches instead).

``loss`` is what the train steps differentiate (``launch.steps``), through
``impl="plain"`` as the reference differentiates ``impl="xla"``: the
kernel wrappers have no backward and refuse an input that requires grad.
``remat=True`` recomputes each layer's activations in the backward
(``torch.utils.checkpoint``; the reference's ``jax.checkpoint``).

Input shapes (the reference's four):

    train_4k     seq 4,096   batch 256   train_step
    prefill_32k  seq 32,768  batch 32    prefill (forward + cache)
    decode_32k   seq 32,768  batch 128   serve_step (1 token + cache)
    long_500k    seq 524,288 batch 1     serve_step, sub-quadratic policy
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.tree import PyTree

LONG_WINDOW = 16_384   # sliding-window size for dense/MoE archs at 500k


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _ported_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in ("decoder", "xlstm", "hybrid"):
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet: ROADMAP Queue 1 item 15")


def decode_window(cfg: ModelConfig, seq_len: int) -> int:
    """Sliding-window policy for long-context decode: none up to 200k tokens,
    else the config's window or ``LONG_WINDOW`` (MLA and xLSTM keep 0)."""
    if seq_len <= 200_000:
        return 0
    if cfg.kind == "xlstm" or cfg.use_mla:
        return 0
    return cfg.sliding_window or LONG_WINDOW


def cache_length(cfg: ModelConfig, seq_len: int) -> int:
    w = decode_window(cfg, seq_len)
    return w if w > 0 else seq_len


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    _ported_kind(cfg)
    if cfg.kind == "xlstm":
        return transformer.xlstm_init(gen, cfg, device)
    if cfg.kind == "hybrid":
        return transformer.hybrid_init(gen, cfg, device)
    return transformer.decoder_init(gen, cfg, device)


def forward(
    params: PyTree,
    cfg: ModelConfig,
    batch: dict,
    *,
    window: int = 0,
    impl: str = "kernel",
    collect_cache: bool = False,
    remat: bool = False,
) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
    _ported_kind(cfg)
    if cfg.kind == "xlstm":
        return transformer.xlstm_forward(params, cfg, batch["tokens"], impl=impl,
                                         collect_cache=collect_cache, remat=remat)
    kw = dict(window=window, impl=impl, collect_cache=collect_cache, remat=remat)
    if cfg.kind == "hybrid":
        return transformer.hybrid_forward(params, cfg, batch["tokens"], **kw)
    return transformer.decoder_forward(
        params, cfg, batch["tokens"], media_embeds=batch.get("media"),
        labels=batch.get("labels"), **kw)


def loss(params: PyTree, cfg: ModelConfig, batch: dict, *, impl: str = "plain",
         remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy of ``batch["labels"]`` plus the forward's
    auxiliary loss; a VLM's media positions carry no labels."""
    logits, _, aux = forward(params, cfg, batch, impl=impl, remat=remat)
    if cfg.num_media_tokens > 0:
        logits = logits[:, cfg.num_media_tokens:, :]
    return transformer.lm_loss(logits, batch["labels"]) + aux


def decode_step(
    params: PyTree,
    cfg: ModelConfig,
    token: torch.Tensor,
    cache: PyTree,
    pos: int,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, PyTree]:
    _ported_kind(cfg)
    if cfg.kind == "xlstm":
        return transformer.xlstm_decode_step(params, cfg, token, cache, pos)
    if cfg.kind == "hybrid":
        return transformer.hybrid_decode_step(params, cfg, token, cache, pos,
                                              window=window)
    return transformer.decoder_decode_step(params, cfg, token, cache, pos,
                                           window=window)


def cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device) -> PyTree:
    _ported_kind(cfg)
    if cfg.kind == "xlstm":
        return transformer.xlstm_cache_init(cfg, batch, dtype, device)
    if cfg.kind == "hybrid":
        return transformer.hybrid_cache_init(cfg, batch, cache_len, dtype, device)
    return transformer.decoder_cache_init(cfg, batch, cache_len, dtype, device)


# ---------------------------------------------------------------------------
# Synthetic batches
# ---------------------------------------------------------------------------

def synth_batch(gen: torch.Generator, cfg: ModelConfig, shape: InputShape,
                device) -> dict:
    """Random int32 tokens (and labels for ``train``) from ``gen``; a decode
    shape gets one token, a zero cache and the last position."""
    _ported_kind(cfg)
    if cfg.num_media_tokens > 0:
        raise NotImplementedError(
            "VLM media embeddings are not ported yet: ROADMAP Queue 1 item 15")
    b, s = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=device, dtype=torch.int32)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": tokens(s)}
        if shape.kind == "train":
            batch["labels"] = tokens(s)
        return batch
    cl = cache_length(cfg, s)
    return {"token": tokens(1),
            "cache": cache_init(cfg, b, cl, transformer._dtype(cfg), device),
            "pos": s - 1}
