"""The paper's language-modality model (Appendix A, Fig. 5), port of
``repro.models.nlp_small``: a small transformer *classifier* — AGNews /
SogouNews are 4- / 5-way classification tasks.  Embedding + learned
positions, N pre-LN encoder blocks, mean-pool over the sequence, head norm,
linear classifier with bias.

Parameters are the reference's tree, unstacked (``blocks/{i}/...``) so
FedPart partitions per block: #1 = embedding (+ positions), #2..#N+1 = the
blocks, #last = the classifier.  Leaves flatten ``blocks < embed < head``.

Attention is ``gqa_full(..., causal=False, impl="plain")``: the reference
differentiates its plain ``impl="xla"`` path, and the port's flash kernel
has no backward (its wrapper refuses gradients).  Every op is functional,
so the model runs under ``torch.func.vmap`` (the vmap engine).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, embedding_init, linear, linear_init,
                                       mlp_apply, mlp_init, norm_apply, norm_init,
                                       normal_init)
from repro_torch.tree import PyTree


def nlp_init(gen: torch.Generator, cfg: ModelConfig, num_classes: int,
             device="cpu") -> PyTree:
    """Random initial parameters drawn from ``gen`` on ``device`` (the
    reference's distributions and shapes)."""
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    params: PyTree = {
        "embed": {
            **embedding_init(gen, cfg.vocab_size, d, dt, device),
            "pos": normal_init(gen, (cfg.max_position_embeddings, d), 0.01, dt, device),
        },
        "blocks": {},
        "head": {
            "norm": norm_init(cfg.norm_kind, d, dt, device),
            "fc": linear_init(gen, d, num_classes, dt, device, bias=True),
        },
    }
    for i in range(cfg.num_layers):
        params["blocks"][str(i)] = {
            "attn_norm": norm_init(cfg.norm_kind, d, dt, device),
            "attn": attn.gqa_init(gen, cfg, dt, device),
            "mlp_norm": norm_init(cfg.norm_kind, d, dt, device),
            "mlp": mlp_init(gen, cfg.mlp_kind, d, cfg.d_ff, dt, device),
        }
    return params


def nlp_pooled(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> (B, d) mean over S of the last block's output,
    before the head norm: the penultimate features MOON reads."""
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    x = x + params["embed"]["pos"][None, :s, :].to(x.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    for i in range(cfg.num_layers):
        p = params["blocks"][str(i)]
        h = norm_apply(cfg.norm_kind, p["attn_norm"], x)
        y, _ = attn.gqa_full(p["attn"], cfg, h, positions, causal=False,
                             impl="plain")
        x = x + y
        h = norm_apply(cfg.norm_kind, p["mlp_norm"], x)
        x = x + mlp_apply(p["mlp"], cfg.mlp_kind, h)
    return x.mean(dim=1)


def nlp_apply(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> class logits (B, num_classes)."""
    x = norm_apply(cfg.norm_kind, params["head"]["norm"],
                   nlp_pooled(params, cfg, tokens))
    return linear(params["head"]["fc"], x)


def nlp_group_key(path: tuple[str, ...]) -> tuple:
    if path[0] == "embed":
        return ("embed",)
    if path[0] == "head":
        return ("head",)
    return ("block", "blocks", int(path[1]))
