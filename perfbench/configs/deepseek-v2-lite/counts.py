"""Operations of DeepSeek-V2-Lite's training and eval steps, per sequence of
``seq_len`` tokens, from its ``config.json`` (``perfbench.flopgraph``), and
of one launch of the grouped expert products (``grouped_launch``).

Products only: MLA's four projections, its scores and their weighting of
the values over the whole S × S square (the plain MLA computes it, the
causal mask discards half), the dense layer's SwiGLU, each MoE layer's
router, its held experts at the expected entries (k × held ÷ experts = 6 ×
8 ÷ 64 = 0.75 a token; the routing decides the real count) and its shared
experts, and the head over the vocabulary slice.  At S 2,048 the forward
is 620,756,992 a token (MLA 39%, the MoE layers 31%, the dense layer 22%,
the head 8%)."""

from __future__ import annotations

from perfbench.flopgraph import DATA, StepCount

F32 = 4


def step(cfg: dict, ref, trained: frozenset[int] | None) -> StepCount:
    """``ref``: the configuration's ``reference`` module (unused here)."""
    s, d, h = cfg["seq_len"], cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, ff, f = cfg["kv_lora_rank"], cfg["intermediate_size"], cfg["moe_intermediate_size"]
    k, e_all, held = cfg["num_experts_per_tok"], cfg["router_experts"], cfg["n_routed_experts"]
    entries = s * k * held / e_all
    sf = f * cfg["n_shared_experts"]
    c = StepCount(trained)
    x = c.op(0, [DATA], [0])                                   # embedding rows
    for i in range(cfg["num_layers"]):
        g = 1 + i
        a = c.op(0, [x], [g])                                  # RMSNorm
        q = c.op(2 * s * d * h * (nope + rope), [a], [g])
        ckv = c.op(2 * s * d * (rank + rope), [a], [g])
        kv = c.op(2 * s * rank * h * (nope + vd), [c.op(0, [ckv], [g])], [g])
        probs = c.op(0, [c.op(2 * s * s * h * nope, [q, kv]),       # scores: nope part,
                         c.op(2 * s * s * h * rope, [q, ckv])])     # rope part; softmax
        att = c.op(2 * s * s * h * vd, [probs, kv])
        x = c.op(0, [x, c.op(2 * s * h * vd * d, [att], [g])])
        m = c.op(0, [x], [g])                                  # RMSNorm
        if i < cfg["first_k_dense_replace"]:
            hid = c.op(2 * 2 * s * d * ff, [m], [g])           # gate and up, SiLU
            out = c.op(2 * s * ff * d, [hid], [g])
        else:
            gates = c.op(2 * s * d * e_all, [m], [g])          # router, softmax, top-k
            hid = c.op(2 * 2 * entries * d * f, [m], [g])      # held experts' gate, up
            routed = c.op(0, [c.op(2 * entries * f * d, [hid], [g]), gates])
            shid = c.op(2 * 2 * s * d * sf, [m], [g])          # shared experts
            out = c.op(0, [routed, c.op(2 * s * sf * d, [shid], [g])])
        x = c.op(0, [x, out])
    head = cfg["num_layers"] + 1
    c.op(2 * s * d * cfg["vocab_size"], [c.op(0, [x], [head])], [head])
    return c


def grouped_launch(kind: str, rows: float, d_in: int, d_out: int,
                   groups: int) -> tuple[float, float]:
    """(operations, bytes) of one grouped-product launch over ``rows`` rows
    in ``groups`` groups (clients × held experts): a forward (or
    input-gradient) launch reads its rows and every group's weight and
    writes its rows; a weight-gradient launch reads both sides' rows and
    writes every group's weight.  f32."""
    if kind not in ("fwd", "wgrad"):
        raise ValueError(f"unknown grouped launch kind {kind!r}")
    return 2.0 * rows * d_in * d_out, F32 * (rows * (d_in + d_out) + groups * d_in * d_out)
