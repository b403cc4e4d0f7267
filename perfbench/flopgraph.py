"""Counting the operations a training step requires, from shapes.

A model's ``counts.py`` walks its forward pass once, calling ``op`` for
every operation in order.  An operation's inputs are earlier operations'
outputs (``Node``) and its parameters' layer groups.  An output needs a
gradient when any input does or any of its parameters is trained.  The
backward of a product (a matmul or convolution) takes one product of the
forward's size per operand that needs a gradient: the activation's
gradient when the activation needs one, the weight's when it is trained.
Elementwise work (norms, activations, softmax, residual adds) is counted
as zero operations; it only carries the need for a gradient.

So a full step counts the forward and twice the forward less the first
layer's input gradient, and a partial step counts the forward and only the
backward that reaches the trained group: nothing below it, and no weight
gradient of a frozen layer.  Recomputation is never counted.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Node:
    needs_grad: bool


class StepCount:
    """Forward and backward operations of one sample's step when the layer
    groups in ``trained`` are trained (``None``: none, a forward only)."""

    def __init__(self, trained: frozenset[int] | None):
        self.trained = trained or frozenset()
        self.forward = 0.0
        self.backward = 0.0

    def op(self, flops: float, inputs=(), groups=()) -> Node:
        need = (sum(1 for n in inputs if n.needs_grad)
                + sum(1 for g in groups if g in self.trained))
        self.forward += flops
        self.backward += flops * need
        return Node(need > 0)

    @property
    def total(self) -> float:
        return self.forward + self.backward


DATA = Node(False)
