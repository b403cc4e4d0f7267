"""Unified model API: one dispatch layer over every architecture kind (port
of ``repro.models.api``).

    init(gen, cfg, device)                          -> params
    forward(params, cfg, batch, ...)                -> (logits, cache|None, aux)
    loss(params, cfg, batch, ...)                   -> scalar training loss
    decode_step(params, cfg, token, cache, pos)     -> (logits, cache)
    cache_init(cfg, batch, cache_len, dtype, device) -> cache
    input_specs(cfg, shape)                         -> {name: meta tensor}
    synth_batch(gen, cfg, shape, device)            -> batch

``kind == "decoder"`` (dense or MoE blocks, GQA or MLA attention, the MTP
head; a VLM's media embeddings ahead of its tokens), ``kind == "encdec"``
(whisper: the batch also carries ``frames``), ``kind == "xlstm"`` (mLSTM /
sLSTM pairs) and ``kind == "hybrid"`` (Zamba2); any other kind raises
``ValueError``, as the reference's.  Randomness comes from an explicit
``torch.Generator`` (the reference's distributions, not its numbers: tests
bridge the reference's params and batches instead).

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
from repro_torch.models import encdec, frontends, transformer
from repro_torch.models.layers import param_dtype
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


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    """False only for ``long_500k`` on an arch that cannot decode 500k
    positions (whisper's bounded decoder)."""
    return shape.name != "long_500k" or cfg.supports_long_decode


def _unknown_kind(cfg: ModelConfig) -> ValueError:
    return ValueError(f"unknown model kind {cfg.kind!r}")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig, device) -> PyTree:
    if cfg.kind == "decoder":
        return transformer.decoder_init(gen, cfg, device)
    if cfg.kind == "encdec":
        return encdec.encdec_init(gen, cfg, device)
    if cfg.kind == "xlstm":
        return transformer.xlstm_init(gen, cfg, device)
    if cfg.kind == "hybrid":
        return transformer.hybrid_init(gen, cfg, device)
    raise _unknown_kind(cfg)


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
    kw = dict(window=window, impl=impl, collect_cache=collect_cache, remat=remat)
    if cfg.kind == "decoder":
        return transformer.decoder_forward(
            params, cfg, batch["tokens"], media_embeds=batch.get("media"),
            labels=batch.get("labels"), **kw)
    if cfg.kind == "encdec":
        return encdec.encdec_forward(params, cfg, batch["tokens"], batch["frames"], **kw)
    if cfg.kind == "xlstm":
        return transformer.xlstm_forward(params, cfg, batch["tokens"], impl=impl,
                                         collect_cache=collect_cache, remat=remat)
    if cfg.kind == "hybrid":
        return transformer.hybrid_forward(params, cfg, batch["tokens"], **kw)
    raise _unknown_kind(cfg)


def loss(params: PyTree, cfg: ModelConfig, batch: dict, *, impl: str = "plain",
         remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy of ``batch["labels"]`` plus the forward's
    auxiliary loss (the MoE load-balance losses and, for an MTP head, its
    weighted loss); a VLM's media positions carry no labels."""
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
    if cfg.kind == "decoder":
        return transformer.decoder_decode_step(params, cfg, token, cache, pos,
                                               window=window)
    if cfg.kind == "encdec":
        return encdec.encdec_decode_step(params, cfg, token, cache, pos, window=window)
    if cfg.kind == "xlstm":
        return transformer.xlstm_decode_step(params, cfg, token, cache, pos)
    if cfg.kind == "hybrid":
        return transformer.hybrid_decode_step(params, cfg, token, cache, pos,
                                              window=window)
    raise _unknown_kind(cfg)


def cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device) -> PyTree:
    if cfg.kind == "decoder":
        return transformer.decoder_cache_init(cfg, batch, cache_len, dtype, device)
    if cfg.kind == "encdec":
        return encdec.encdec_cache_init(cfg, batch, cache_len, dtype, device)
    if cfg.kind == "xlstm":
        return transformer.xlstm_cache_init(cfg, batch, dtype, device)
    if cfg.kind == "hybrid":
        return transformer.hybrid_cache_init(cfg, batch, cache_len, dtype, device)
    raise _unknown_kind(cfg)


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no storage) + synthetic batches
# ---------------------------------------------------------------------------

def _token_len(cfg: ModelConfig, seq_len: int) -> int:
    """VLM: media embeddings occupy the first ``num_media_tokens`` positions."""
    return seq_len - cfg.num_media_tokens


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The inputs of ``shape`` as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct``): int32 tokens (and labels for ``train``),
    whisper's frames and a VLM's media in the activation dtype; a decode
    shape's one token, its cache in the param dtype and a scalar position."""
    b, s = shape.global_batch, shape.seq_len

    def i32(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind in ("train", "prefill"):
        st = _token_len(cfg, s)
        specs = {"tokens": i32(b, st)}
        if cfg.kind == "encdec":
            specs["frames"] = frontends.frame_embeds_spec(cfg, b)
        if cfg.num_media_tokens > 0:
            specs["media"] = frontends.media_embeds_spec(cfg, b)
        if shape.kind == "train":
            specs["labels"] = i32(b, st)
        return specs
    cache = cache_init(cfg, b, cache_length(cfg, s), param_dtype(cfg), "meta")
    return {"token": i32(b, 1), "cache": cache, "pos": i32()}


def synth_batch(gen: torch.Generator, cfg: ModelConfig, shape: InputShape,
                device) -> dict:
    """A random batch matching ``input_specs``, drawn from ``gen`` on
    ``device``: int32 tokens (and labels for ``train``; a VLM's number
    ``seq_len - num_media_tokens``), N(0, 1) frames or media; a decode shape
    gets one token, a zero cache and the last position."""
    b, s = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=device, dtype=torch.int32)

    if shape.kind in ("train", "prefill"):
        st = _token_len(cfg, s)
        batch = {"tokens": tokens(st)}
        if cfg.kind == "encdec":
            batch["frames"] = frontends.synth_frame_embeds(gen, cfg, b, device)
        if cfg.num_media_tokens > 0:
            batch["media"] = frontends.synth_media_embeds(gen, cfg, b, device)
        if shape.kind == "train":
            batch["labels"] = tokens(st)
        return batch
    cl = cache_length(cfg, s)
    return {"token": tokens(1),
            "cache": cache_init(cfg, b, cl, param_dtype(cfg), device),
            "pos": s - 1}
