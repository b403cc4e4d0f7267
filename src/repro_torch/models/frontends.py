"""Stub modality frontends (port of ``repro.models.frontends``).

``[audio]`` and ``[vlm]`` architectures specify the transformer backbone
only; the mel-spectrogram / conv feature extractor (whisper) and the ViT
vision tower + projector (llava) are represented by *precomputed embedding
inputs* of the right shape.  This module holds those shapes: tensors on
the ``meta`` device (torch's counterpart of a ``ShapeDtypeStruct``: a shape
and a dtype, no storage) for ``api.input_specs``, and random embeddings
drawn from an explicit ``torch.Generator`` for ``api.synth_batch``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_dtype


def _frames_shape(cfg: ModelConfig, batch: int) -> tuple[int, int, int]:
    return batch, cfg.encoder_seq, cfg.d_model


def _media_shape(cfg: ModelConfig, batch: int) -> tuple[int, int, int]:
    return batch, cfg.num_media_tokens, cfg.d_model


def frame_embeds_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """Whisper stub: conv-frontend output frames (B, encoder_seq, d_model)."""
    return torch.empty(_frames_shape(cfg, batch), dtype=act_dtype(cfg),
                       device="meta")


def media_embeds_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """VLM stub: projected vision-tower patch embeddings (B, n_media, d)."""
    return torch.empty(_media_shape(cfg, batch), dtype=act_dtype(cfg),
                       device="meta")


def synth_frame_embeds(gen: torch.Generator, cfg: ModelConfig, batch: int,
                       device) -> torch.Tensor:
    """N(0, 1) frames in the activation dtype, from ``gen`` on ``device``."""
    return torch.randn(_frames_shape(cfg, batch), generator=gen, device=device,
                       dtype=act_dtype(cfg))


def synth_media_embeds(gen: torch.Generator, cfg: ModelConfig, batch: int,
                       device) -> torch.Tensor:
    """N(0, 1) media embeddings in the activation dtype, from ``gen`` on
    ``device``."""
    return torch.randn(_media_shape(cfg, batch), generator=gen, device=device,
                       dtype=act_dtype(cfg))
