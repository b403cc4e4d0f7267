"""GQA/MQA attention, full-sequence and one-token decode (port of the GQA half
of ``repro.models.attention``; MLA is not ported yet and raises).

* ``gqa_full``   — whole-sequence forward (prefill).  Returns the output and
  the sequence's K/V (prefill writes them to the cache).
* ``gqa_decode`` — one-token step against an existing cache.  Unlike the
  reference, which returns new cache arrays, it writes the token's K/V
  into the given cache tensors in place (a serve step would otherwise copy
  every layer's whole cache) and returns them.  Sliding-window caches are
  ring buffers: RoPE is applied at write time with absolute positions.

``_sdpa`` has two implementations:

* ``impl="kernel"`` (the default): a sequence longer than one token goes
  through the hand-written CUDA flash-attention kernel
  (``kernels.flash_attention.ops.flash_attention``) with the caller's real
  ``causal`` and ``window``; on CPU tensors that is its plain version.  The
  reference's ``impl="pallas"`` passes only ``mask=`` to its kernel wrapper,
  which ignores it, so there every sequence runs causal with no window; the
  port does not copy that.  One-token decode takes the plain path, as the
  reference's does.
* ``impl="plain"``: the reference's ``impl="xla"`` branch, op for op
  (scores in the activation dtype, then f32 softmax, probabilities cast
  back to q's dtype).

``act_sharding.constrain_scores`` is not ported: it only adds a sharding
constraint for a device mesh, and the port runs on one device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, linear, linear_init, rope_angles
from repro_torch.tree import PyTree

NEG_INF = -1e30
IMPLS = ("kernel", "plain")


def _no_mla(cfg: ModelConfig) -> None:
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet: ROADMAP Queue 1 item 15")


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             n: int | None = None) -> PyTree:
    _no_mla(cfg)
    hd = cfg.resolved_head_dim
    return {
        "wq": linear_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, device, n=n),
        "wk": linear_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device, n=n),
        "wv": linear_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device, n=n),
        "wo": linear_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, device, n=n),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _sdpa(q, k, v, mask, impl: str = "kernel", *, causal: bool = True,
          window: int = 0):
    """q: (B,S,H,D); k/v: (B,T,Hkv,D); mask: (B,S,T) or (S,T) bool, read by
    the plain path; the kernel takes ``causal`` / ``window`` instead."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    b, s, h, d = q.shape
    if impl == "kernel" and s > 1:
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    rep = h // k.shape[2]
    kr = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vr = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bshd,bthd->bhst", q, kr).float() * scale
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        logits = torch.where(m[:, None, :, :], logits,
                             torch.tensor(NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, vr)


def causal_mask(s: int, window: int, device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m


def gqa_full(
    params: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    causal: bool = True,
    impl: str = "kernel",
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention.  Returns (y, (k, v)) for the cache."""
    _no_mla(cfg)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _split_heads(linear(params["wq"], x), cfg.num_heads, hd)
    k = _split_heads(linear(params["wk"], x), cfg.num_kv_heads, hd)
    v = _split_heads(linear(params["wv"], x), cfg.num_kv_heads, hd)
    if cfg.use_rope:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # the kernel path never reads the mask, so it is built for the plain one only
    mask = causal_mask(s, window, x.device) if causal and impl == "plain" else None
    y = _sdpa(q, k, v, mask, impl=impl, causal=causal, window=window)
    y = linear(params["wo"], y.reshape(b, s, cfg.num_heads * hd))
    return y, (k, v)


def gqa_decode(
    params: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode.  x: (B,1,d); caches: (B,W,Hkv,D), written in place
    at the token's slot; pos: the token's absolute position.

    ``window == 0`` means the cache length equals the full context and slot
    index == absolute position.  ``window > 0`` means a ring buffer of W slots.
    """
    _no_mla(cfg)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    cache_len = k_cache.shape[1]
    q = _split_heads(linear(params["wq"], x), cfg.num_heads, hd)
    k = _split_heads(linear(params["wk"], x), cfg.num_kv_heads, hd)
    v = _split_heads(linear(params["wv"], x), cfg.num_kv_heads, hd)
    if cfg.use_rope:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_angles(posv, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    slot = pos % cache_len if window > 0 else pos
    k_cache[:, slot:slot + 1] = k.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v.to(v_cache.dtype)
    # Valid slots: all once pos+1 >= cache_len, else indices <= pos.
    idx = torch.arange(cache_len, device=x.device)
    valid = torch.ones_like(idx, dtype=torch.bool) if pos + 1 >= cache_len else idx <= pos
    mask = valid[None, None, :].expand(b, 1, cache_len)
    y = _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, impl="plain")
    y = linear(params["wo"], y.reshape(b, 1, cfg.num_heads * hd))
    return y, (k_cache, v_cache)
