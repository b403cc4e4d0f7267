"""Bytes and operations of one launch of the cohort masked-Adam kernel
(``masked_adam_cohort_kernel``), from the leaves a round trains.

Per client and trained element, the update reads p, g, m and v and writes
p, m and v once: 28 bytes in float32, and 14 operations (m: 3, v: 4, the
two bias corrections, the square root, eps, the division, lr and the
subtraction).  The mask: one 32-bit word per client and block of
``BLOCK_ELEMS`` elements of every leaf.  Leaves not trained are not read.
"""

from __future__ import annotations

from perfbench.fedref import Leaf, trained_paths

BYTES_PER_ELEM = 7 * 4
OPS_PER_ELEM = 14
BLOCK_ELEMS = 8 * 128


def masked_adam_launch(leaves: list[Leaf], group: int, clients: int) -> tuple[float, float]:
    """(bytes, operations) of one launch for a round training ``group``
    (``-1``: every group) over ``clients`` clients."""
    train = set(trained_paths(leaves, group))
    elems = sum(lf.numel for lf in leaves if lf.path in train)
    blocks = sum(-(-lf.numel // BLOCK_ELEMS) for lf in leaves)
    return (float(clients * (elems * BYTES_PER_ELEM + blocks * 4)),
            float(clients * elems * OPS_PER_ELEM))
