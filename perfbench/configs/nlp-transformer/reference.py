"""Plain PyTorch reference of the nlp-transformer text classifier (the
paper's language model, Appendix A, Fig. 5), in float32, from its
``config.json``: token embedding plus learned positions, ``num_layers``
pre-LayerNorm encoder blocks (non-causal multi-head attention, GELU MLP
with tanh approximation), mean-pool over the sequence, LayerNorm, linear
classifier with bias.  Weights are ``(in, out)``, ``y = x @ w``.

Layer groups, shallow to deep: the embedding (table and positions), each
block, the head.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.fedref import Leaf
from perfbench.synthetic import make_text_dataset

LN_EPS = 1e-5


def leaves(cfg: dict) -> list[Leaf]:
    d, ff, n_l = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    head = 1 + n_l
    out = [Leaf("embed/table", (cfg["vocab_size"], d), 0, std=0.02),
           Leaf("embed/pos", (cfg["max_position_embeddings"], d), 0, std=0.01),
           Leaf("head/norm/scale", (d,), head, fill=1.0),
           Leaf("head/norm/bias", (d,), head),
           Leaf("head/fc/w", (d, cfg["num_classes"]), head, std=1 / math.sqrt(d)),
           Leaf("head/fc/b", (cfg["num_classes"],), head)]
    for i in range(n_l):
        b, g = f"blocks/{i}", 1 + i
        for norm in ("attn_norm", "mlp_norm"):
            out += [Leaf(f"{b}/{norm}/scale", (d,), g, fill=1.0),
                    Leaf(f"{b}/{norm}/bias", (d,), g)]
        for w in ("wq", "wk", "wv", "wo"):
            out.append(Leaf(f"{b}/attn/{w}/w", (d, d), g, std=1 / math.sqrt(d)))
        out += [Leaf(f"{b}/mlp/w_in/w", (d, ff), g, std=1 / math.sqrt(d)),
                Leaf(f"{b}/mlp/w_in/b", (ff,), g),
                Leaf(f"{b}/mlp/w_out/w", (ff, d), g, std=1 / math.sqrt(ff)),
                Leaf(f"{b}/mlp/w_out/b", (d,), g)]
    return out


def num_groups(cfg: dict) -> int:
    return cfg["num_layers"] + 2


def make_data(cfg: dict, num_samples: int, seed: int):
    return make_text_dataset(cfg["num_classes"], cfg["vocab_size"], cfg["seq_len"],
                             num_samples, seed)


def _layernorm(x, p, name):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p[f"{name}/scale"] + p[f"{name}/bias"]


def logits(p: dict, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    h, d = cfg["num_heads"], cfg["d_model"]
    hd = d // h
    x = p["embed/table"][tokens] + p["embed/pos"][:s]
    for i in range(cfg["num_layers"]):
        pre = f"blocks/{i}"
        a = _layernorm(x, p, f"{pre}/attn_norm")
        q, k, v = (torch.matmul(a, p[f"{pre}/attn/{w}/w"]).view(b, s, h, hd)
                   .transpose(1, 2) for w in ("wq", "wk", "wv"))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.matmul(torch.softmax(scores, dim=-1), v)
        x = x + torch.matmul(att.transpose(1, 2).reshape(b, s, d), p[f"{pre}/attn/wo/w"])
        m = _layernorm(x, p, f"{pre}/mlp_norm")
        m = F.gelu(torch.matmul(m, p[f"{pre}/mlp/w_in/w"]) + p[f"{pre}/mlp/w_in/b"],
                   approximate="tanh")
        x = x + torch.matmul(m, p[f"{pre}/mlp/w_out/w"]) + p[f"{pre}/mlp/w_out/b"]
    pooled = _layernorm(x.mean(dim=1), p, "head/norm")
    return torch.matmul(pooled, p["head/fc/w"]) + p["head/fc/b"]


def loss(p: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the batch."""
    return F.cross_entropy(logits(p, cfg, tokens), labels)
