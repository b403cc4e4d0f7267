"""A decoder-only causal LM with one parameter subtree per layer, for the FL
round loop (``fl.tasks.lm_task``): the blocks of ``models.transformer``
(``block_init`` / ``block_forward``: MLA or GQA attention, a dense MLP or
the MoE layer), unstacked, so each layer is a layer group of its own:

    {"embed": {"table"}, "layers": {"0": block, "1": block, ...},
     "final_norm": {"scale"}, "head": {"w"}}

Layer groups, shallow to deep: the embedding, each layer, then the final
norm with the head (``core.partition.default_group_key``).  The loss is
next-token cross-entropy over the (B, S) labels, plus the MoE layers'
balance losses; the eval reads next-token accuracy.  Attention runs plain
(``impl="plain"``): the training forward needs a backward, which the serving
kernels do not have.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (act_dtype, embed, embedding_init, linear,
                                       linear_init, norm_apply, norm_init, param_dtype)
from repro_torch.models.transformer import block_forward, block_init, decoder_layout
from repro_torch.tree import PyTree


def lm_init(gen: torch.Generator, cfg: ModelConfig, device="cpu") -> PyTree:
    dt = param_dtype(cfg)
    n_dense, _ = decoder_layout(cfg)
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "layers": {str(i): block_init(gen, cfg, device, use_moe=i >= n_dense)
                   for i in range(cfg.num_layers)},
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, device),
        "head": linear_init(gen, cfg.d_model, cfg.vocab_size, dt, device),
    }


def lm_logits(params: PyTree, cfg: ModelConfig,
              tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> ((B, S, V) f32 logits, the summed balance losses)."""
    x = embed(params["embed"], tokens, act_dtype(cfg))
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    n_dense, _ = decoder_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, _, a = block_forward(params["layers"][str(i)], cfg, x, positions, window=0,
                                impl="plain", use_moe=i >= n_dense)
        aux = aux + a
    x = norm_apply(cfg.norm_kind, params["final_norm"], x)
    return linear(params["head"], x.float()), aux


def lm_loss(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of the (B, S) labels, plus the balance
    losses."""
    logits, aux = lm_logits(params, cfg, tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)) + aux


def lm_accuracy(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Share of the (B, S) labels that are the logits' largest (0-d)."""
    logits, _ = lm_logits(params, cfg, tokens)
    return (logits.argmax(dim=-1) == labels).float().mean()
