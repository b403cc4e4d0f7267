"""Operations of the nlp-transformer's training and eval steps, per sample,
from its ``config.json`` (``perfbench.flopgraph``).  Products only: the
projections, the attention scores and their weighting of the values, the
MLP, the classifier; per token and block the forward is
``8 d² + 4 S d + 4 d d_ff`` (1,835,008 at d 256, S 256, d_ff 1,024)."""

from __future__ import annotations

from perfbench.flopgraph import DATA, StepCount


def step(cfg: dict, ref, trained: frozenset[int] | None) -> StepCount:
    """``ref``: the configuration's ``reference`` module (unused here)."""
    s, d, ff = cfg["seq_len"], cfg["d_model"], cfg["d_ff"]
    c = StepCount(trained)
    x = c.op(0, [DATA], [0])                      # embedding rows + positions
    for i in range(cfg["num_layers"]):
        g = 1 + i
        a = c.op(0, [x], [g])                     # LayerNorm
        q, k, v = (c.op(2 * s * d * d, [a], [g]) for _ in range(3))
        probs = c.op(2 * s * s * d, [q, k])       # scores, then softmax
        att = c.op(2 * s * s * d, [probs, v])
        x = c.op(0, [x, c.op(2 * s * d * d, [att], [g])])
        m = c.op(0, [x], [g])                     # LayerNorm
        h = c.op(2 * s * d * ff, [m], [g])        # w_in, bias, GELU
        x = c.op(0, [x, c.op(2 * s * ff * d, [h], [g])])
    head = cfg["num_layers"] + 1
    pooled = c.op(0, [x], [head])                 # mean pool, LayerNorm
    c.op(2 * d * cfg["num_classes"], [pooled], [head])
    return c
