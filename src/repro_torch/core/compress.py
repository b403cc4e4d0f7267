"""Lossy compression of transmitted subtrees (port of ``repro.core.compress``).

FedPart already shrinks communication structurally — partial rounds move
only the scheduled group's subtree (Eq. 5).  This module shrinks the
remaining bytes further by compressing each client's update at the
transmission boundary:

* ``int8``   — symmetric per-block quantization: ``q = round(127 x / s)``
  with ``s = max|x|`` per block, dequantized as ``q s / 127``;
* ``onebit`` — the sign with a per-block magnitude ``s = mean|x|``
  (zero maps to ``+s``), dequantized as ``±s``;
* ``topk``   — per-leaf magnitude top-k: the ``k = min(n, max(1,
  ceil(topk_fraction n)))`` largest-|x| elements travel as (value, index)
  pairs, the rest are dropped.

Each scheme compresses the client's update ``u = local - global``.  With
``error_feedback`` every client carries a residual ``r``: it transmits
``c = Q(u + r)`` and keeps ``r' = (u + r) - c``, so the quantization error
telescopes across rounds.  ``block_rows = 0`` uses one scale per leaf,
``block_rows = B`` blocks of ``B * 128`` elements, zero-padded per leaf
(onebit's mean counts only the valid elements).

Two realisations, equal bit for bit on the same input and device:

* ``qdq_leaf`` / ``transmit_leaf`` / ``transmit_tree*`` — the
  quantize-dequantize values the engines aggregate.  Every function takes
  ``stacked=True`` for trees with a leading client axis (the vmap engine's
  layout), quantizing each client's slice on its own;
* ``encode_leaf`` / ``decode_leaf`` — the wire format (int8 codes, packed
  sign bits, (value, index) pairs, per-block f32 scales) as host numpy
  arrays, whose bytes equal the analytic ledger (``leaf_encoded_bytes``)
  that ``core.costs.comm_cost`` books.

Rounding is half to even on both sides (``torch.round``, ``jnp.round``).
Among equal magnitudes ``torch.topk`` and ``jax.lax.top_k`` may keep
different indices; the decoded values and the byte counts do not depend
on that choice unless the k-th magnitude itself is tied.

Client-local statistics (BN running moments) never travel and are never
compressed; they keep the dense 4-bytes-per-element ledger basis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import is_local_stat
from repro_torch.core.partition import Partition
from repro_torch.tree import PyTree, tree_map, tree_map_with_path, tree_paths

KINDS = ("none", "int8", "onebit", "topk")

#: lane width of one packed block row, as ``kernels/masked_adam/ops``: so
#: ``block_rows=8`` gives the kernel's 8x128 block grid.
LANES = 128

F32_BYTES = 4
INT8_BYTES = 1
SCALE_BYTES = 4      # one f32 scale per block
INDEX_BYTES = 4      # one int32 index per retained top-k element


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """One transmission-compression scheme.  ``kind`` is never ``"none"``:
    no compression is ``None`` (``make_config``), so the uncompressed paths
    stay structurally untouched."""

    kind: str
    topk_fraction: float = 0.01
    error_feedback: bool = True
    block_rows: int = 0          # 0 = one block (scale) per leaf

    def __post_init__(self):
        if self.kind not in KINDS[1:]:
            raise ValueError(
                f"compression kind must be one of {KINDS[1:]}, got {self.kind!r}"
                " (represent 'none' as None — make_config does this)")
        if self.kind == "topk" and not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {self.topk_fraction}")
        if self.block_rows < 0:
            raise ValueError(f"block_rows must be >= 0, got {self.block_rows}")

    @property
    def block_elems(self) -> int:
        """Elements per scale block (0 = whole leaf)."""
        return self.block_rows * LANES


def make_config(kind: str = "none", *, topk_fraction: float = 0.01,
                error_feedback: bool = True,
                block_rows: int = 0) -> CompressionConfig | None:
    """``FLRunConfig`` string -> config object, or ``None`` for ``"none"``."""
    if kind == "none":
        return None
    if kind not in KINDS:
        raise ValueError(f"compression must be one of {KINDS}, got {kind!r}")
    return CompressionConfig(kind=kind, topk_fraction=topk_fraction,
                             error_feedback=error_feedback,
                             block_rows=block_rows)


# ---------------------------------------------------------------------------
# Block geometry (shared by the values, the wire format and the ledger)
# ---------------------------------------------------------------------------

def _num_blocks(n: int, cfg: CompressionConfig) -> int:
    if n == 0:
        return 0
    be = cfg.block_elems or n
    return -(-n // be)


def _topk_k(n: int, cfg: CompressionConfig) -> int:
    if n == 0:
        return 0
    return min(n, max(1, math.ceil(cfg.topk_fraction * n)))


def _blocked(flat: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """``flat`` ``(K, n)`` zero-padded to whole blocks: ``(K, nb, be)``."""
    n = flat.shape[1]
    be = cfg.block_elems or n
    nb = -(-n // be)
    if nb * be > n:
        flat = torch.nn.functional.pad(flat, (0, nb * be - n))
    return flat.reshape(-1, nb, be)


def _int8_scales(blocks: torch.Tensor) -> torch.Tensor:
    s = blocks.abs().amax(dim=-1, keepdim=True)
    return torch.where(s > 0, s, torch.ones_like(s))


def _int8_codes(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks * (127.0 / scale)), -127.0, 127.0)


def _onebit_scales(blocks: torch.Tensor, n: int) -> torch.Tensor:
    """Mean |x| per block over its valid elements (the last block of a leaf
    may be zero-padded)."""
    nb, be = blocks.shape[-2:]
    cnt = torch.full((nb, 1), float(be), device=blocks.device)
    cnt[-1] = float(n - (nb - 1) * be)
    return blocks.abs().sum(dim=-1, keepdim=True) / cnt


def _topk_idx(flat: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(flat.abs(), k, dim=-1, sorted=True).indices


# ---------------------------------------------------------------------------
# Quantize -> dequantize (the values the engines aggregate)
# ---------------------------------------------------------------------------

def _qdq_flat(flat: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """Quantize-dequantize each row of ``flat`` ``(K, n)`` f32."""
    n = flat.shape[1]
    if cfg.kind == "topk":
        idx = _topk_idx(flat, _topk_k(n, cfg))
        return torch.zeros_like(flat).scatter(1, idx, flat.gather(1, idx))
    blocks = _blocked(flat, cfg)
    if cfg.kind == "int8":
        scale = _int8_scales(blocks)
        deq = _int8_codes(blocks, scale) * (scale / 127.0)
    elif cfg.kind == "onebit":
        scale = _onebit_scales(blocks, n)
        deq = torch.where(blocks >= 0, scale, -scale)
    else:  # pragma: no cover - guarded by CompressionConfig
        raise ValueError(f"unknown compression kind {cfg.kind!r}")
    return deq.reshape(flat.shape[0], -1)[:, :n]


def qdq_leaf(x: torch.Tensor, cfg: CompressionConfig, *,
             stacked: bool = False) -> torch.Tensor:
    """Quantize-dequantize one f32 leaf (each client's slice on its own
    when ``stacked``): the values the server sees after decoding the wire
    format, ``decode_leaf(encode_leaf(x))`` bit for bit."""
    n = math.prod(x.shape[1:] if stacked else x.shape)
    if n == 0:
        return x
    flat = x.to(torch.float32).reshape(-1, n)
    return _qdq_flat(flat, cfg).reshape(x.shape)


def transmit_leaf(g_leaf: torch.Tensor, local_leaf: torch.Tensor,
                  res_leaf: torch.Tensor, cfg: CompressionConfig, *,
                  stacked: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's error-feedback transmission step: ``u = local - global``,
    ``c = Q(u + r)``, ``r' = (u + r) - c``.  Returns the server view
    ``global + c`` (in the leaf's dtype) and the new f32 residual; without
    error feedback ``c = Q(u)`` and the residual stays as it was.  With
    ``stacked`` the local and residual leaves carry the client axis and the
    global leaf broadcasts over it."""
    g32 = g_leaf.to(torch.float32)
    u = local_leaf.to(torch.float32) - g32
    t = u + res_leaf if cfg.error_feedback else u
    c = qdq_leaf(t, cfg, stacked=stacked)
    new_res = (t - c) if cfg.error_feedback else res_leaf
    return (g32 + c).to(local_leaf.dtype), new_res


def init_residual(params: PyTree) -> PyTree:
    """Fresh all-zero f32 error-feedback residual for one client (or a
    stacked cohort, given stacked params)."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def _split_pairs(like: PyTree, pairs: PyTree) -> tuple[PyTree, PyTree]:
    """A tree of ``(tx, residual)`` leaves, shaped like ``like`` -> the two
    trees (walked by ``like``'s structure, so the pairs stay leaves)."""
    return (tree_map(lambda _, pr: pr[0], like, pairs),
            tree_map(lambda _, pr: pr[1], like, pairs))


def transmit_tree(global_params: PyTree, local: PyTree, residual: PyTree,
                  cfg: CompressionConfig, *, partition: Partition,
                  groups: Sequence[int] | None = None,
                  stacked: bool = False) -> tuple[PyTree, PyTree]:
    """The transmission step on every transmitted leaf of a client's tree
    (``stacked``: of a cohort's): leaves outside ``groups`` (``None`` = all)
    and client-local statistics pass through (``local`` value, residual
    untouched) — they do not travel.  Returns ``(tx, new_residual)``; ``tx``
    is the tree aggregation consumes in place of ``local``."""
    sel = None if groups is None else frozenset(int(g) for g in groups)

    def _leaf(path, g_leaf, l_leaf, r_leaf):
        if is_local_stat(path) or (sel is not None
                                   and partition.group_of(path) not in sel):
            return (l_leaf, r_leaf)
        return transmit_leaf(g_leaf, l_leaf, r_leaf, cfg, stacked=stacked)

    pairs = tree_map_with_path(_leaf, global_params, local, residual)
    return _split_pairs(global_params, pairs)


def transmit_tree_plan(global_params: PyTree, local: PyTree, residual: PyTree,
                       gmask, cfg: CompressionConfig, *, partition: Partition,
                       stacked: bool = False) -> tuple[PyTree, PyTree]:
    """``transmit_tree`` under a per-client layer plan: ``gmask`` is the
    client's ``(M,)`` trained-group bits (``stacked``: ``(K, M)``, one row
    per client).  A leaf whose group bit is off keeps ``local`` and its
    residual; statistics never travel."""
    device = tree_paths(local)[0][1].device
    bits = torch.as_tensor(gmask, device=device) != 0

    def _leaf(path, g_leaf, l_leaf, r_leaf):
        if is_local_stat(path):
            return (l_leaf, r_leaf)
        bit = bits[..., partition.group_of(path)]
        if stacked:
            bit = bit.view(-1, *([1] * (l_leaf.dim() - 1)))
        tx, nr = transmit_leaf(g_leaf, l_leaf, r_leaf, cfg, stacked=stacked)
        return torch.where(bit, tx, l_leaf), torch.where(bit, nr, r_leaf)

    pairs = tree_map_with_path(_leaf, global_params, local, residual)
    return _split_pairs(global_params, pairs)


# ---------------------------------------------------------------------------
# Wire format (host numpy; what the byte ledger prices)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncodedLeaf:
    """One leaf's encoded payload; ``nbytes`` is the arrays' storage, equal
    to ``leaf_encoded_bytes``."""

    kind: str
    shape: tuple[int, ...]
    dtype: Any                          # the leaf's torch dtype
    payload: np.ndarray                 # int8 codes / packed sign bits / f32 values
    scales: np.ndarray | None = None    # (nblocks,) f32, quantized kinds only
    indices: np.ndarray | None = None   # (k,) int32, topk only

    @property
    def nbytes(self) -> int:
        total = self.payload.nbytes
        if self.scales is not None:
            total += self.scales.nbytes
        if self.indices is not None:
            total += self.indices.nbytes
        return total


def encode_leaf(x: torch.Tensor, cfg: CompressionConfig) -> EncodedLeaf:
    """Encode one leaf into its wire format: computed on ``x``'s device with
    the arithmetic of ``qdq_leaf``, returned as host numpy arrays."""
    x = torch.as_tensor(x)
    n = x.numel()
    flat = x.to(torch.float32).reshape(1, n)
    shape = tuple(x.shape)
    if cfg.kind == "topk":
        idx = _topk_idx(flat, _topk_k(n, cfg))
        vals = flat.gather(1, idx)
        return EncodedLeaf(kind=cfg.kind, shape=shape, dtype=x.dtype,
                           payload=vals[0].cpu().numpy(),
                           indices=idx[0].to(torch.int32).cpu().numpy())
    blocks = _blocked(flat, cfg)
    if cfg.kind == "int8":
        scale = _int8_scales(blocks)
        codes = _int8_codes(blocks, scale).reshape(-1)[:n].to(torch.int8)
        return EncodedLeaf(kind=cfg.kind, shape=shape, dtype=x.dtype,
                           payload=codes.cpu().numpy(),
                           scales=scale.reshape(-1).cpu().numpy())
    if cfg.kind == "onebit":
        scale = _onebit_scales(blocks, n)
        signs = (flat[0] >= 0).cpu().numpy()
        return EncodedLeaf(kind=cfg.kind, shape=shape, dtype=x.dtype,
                           payload=np.packbits(signs),
                           scales=scale.reshape(-1).cpu().numpy())
    raise ValueError(f"unknown compression kind {cfg.kind!r}")


def decode_leaf(enc: EncodedLeaf, cfg: CompressionConfig,
                device="cpu") -> torch.Tensor:
    """Decode back to the leaf's shape and dtype on ``device``: bit for bit
    ``qdq_leaf`` of the encoded tensor, computed on the same device."""
    n = math.prod(enc.shape)
    if enc.kind == "topk":
        flat = torch.zeros(n, dtype=torch.float32, device=device)
        idx = torch.as_tensor(enc.indices, device=device).long()
        deq = flat.scatter(0, idx, torch.as_tensor(enc.payload, device=device))
        return deq.reshape(enc.shape).to(enc.dtype)
    nb = enc.scales.shape[0]
    be = cfg.block_elems or n
    scale = torch.as_tensor(enc.scales, device=device).reshape(nb, 1)
    if enc.kind == "int8":
        q = torch.as_tensor(enc.payload, device=device).to(torch.float32)
        q = torch.nn.functional.pad(q, (0, nb * be - n)).reshape(nb, be)
        deq = q * (scale / 127.0)
    elif enc.kind == "onebit":
        bits = torch.as_tensor(np.unpackbits(enc.payload)[:n].astype(bool),
                               device=device)
        bits = torch.nn.functional.pad(bits, (0, nb * be - n)).reshape(nb, be)
        deq = torch.where(bits, scale, -scale)
    else:
        raise ValueError(f"unknown compression kind {enc.kind!r}")
    return deq.reshape(-1)[:n].reshape(enc.shape).to(enc.dtype)


# ---------------------------------------------------------------------------
# Analytic byte ledger (consumed by core.costs)
# ---------------------------------------------------------------------------

def leaf_encoded_bytes(n: int, cfg: CompressionConfig | None) -> int:
    """Wire bytes of one transmitted leaf of ``n`` elements: payload plus
    per-block scales plus top-k indices; ``cfg=None`` is dense f32."""
    if n == 0:
        return 0
    if cfg is None:
        return F32_BYTES * n
    nb = _num_blocks(n, cfg)
    if cfg.kind == "int8":
        return INT8_BYTES * n + SCALE_BYTES * nb
    if cfg.kind == "onebit":
        return -(-n // 8) + SCALE_BYTES * nb
    if cfg.kind == "topk":
        return _topk_k(n, cfg) * (F32_BYTES + INDEX_BYTES)
    raise ValueError(f"unknown compression kind {cfg.kind!r}")


def _leaf_bytes(path: str, leaf, cfg: CompressionConfig | None) -> int:
    n = math.prod(tuple(leaf.shape))
    return leaf_encoded_bytes(n, None if is_local_stat(path) else cfg)


def group_encoded_bytes(params: PyTree, partition: Partition,
                        cfg: CompressionConfig | None) -> np.ndarray:
    """Per-group transmitted bytes under ``cfg``; client-local statistics
    keep the dense f32 basis, so ``cfg=None`` is the dense ledger."""
    out = np.zeros(partition.num_groups, dtype=np.int64)
    for path, leaf in tree_paths(params):
        p = "/".join(path)
        out[partition.group_of(p)] += _leaf_bytes(p, leaf, cfg)
    return out


def tree_encoded_bytes(tree: PyTree, cfg: CompressionConfig | None) -> int:
    """Total wire bytes of one (possibly pruned) transmitted subtree."""
    return sum(_leaf_bytes("/".join(path), leaf, cfg)
               for path, leaf in tree_paths(tree))
