"""Operations of ResNet-18's training and eval steps, per image, from its
``config.json`` (``perfbench.flopgraph``): every convolution, the 1 × 1
shortcuts and the head; a convolution's forward is ``2 k² c_in c_out`` per
output position."""

from __future__ import annotations

from perfbench.flopgraph import DATA, StepCount


def step(cfg: dict, ref, trained: frozenset[int] | None) -> StepCount:
    """``ref``: the configuration's ``reference`` module (its block list)."""
    c = StepCount(trained)
    hw = cfg["image_size"]
    x = c.op(2 * 9 * cfg["in_channels"] * cfg["channels"][0] * hw * hw, [DATA], [0])
    x = c.op(0, [x], [0])                         # BatchNorm, ReLU
    for i, (_, ci, co, stride) in enumerate(ref.blocks(cfg)):
        g1, g2 = 1 + 2 * i, 2 + 2 * i
        out = -(-hw // stride)
        h = c.op(0, [c.op(2 * 9 * ci * co * out * out, [x], [g1])], [g1])
        h = c.op(0, [c.op(2 * 9 * co * co * out * out, [h], [g2])], [g2])
        if stride != 1 or ci != co:
            x = c.op(0, [c.op(2 * ci * co * out * out, [x], [g1])], [g1])
        x = c.op(0, [h, x])
        hw = out
    head = 1 + 2 * len(ref.blocks(cfg))
    c.op(2 * cfg["channels"][-1] * cfg["num_classes"], [x], [head])
    return c
