"""GQA/MQA and DeepSeek's MLA (multi-head latent attention), full-sequence
and one-token decode (port of ``repro.models.attention``).

* ``gqa_full`` / ``mla_full``   — whole-sequence forward (prefill).  Return
  the output and the sequence's cache tensors: GQA's K/V, MLA's latent
  ``c_kv`` (B, S, kv_lora_rank) and ``k_rope`` (B, S, rope).
* ``gqa_decode`` / ``mla_decode`` — one-token step against an existing
  cache.  Unlike the reference, which returns new cache arrays, they write
  the token's entries into the given cache tensors in place (a serve step
  would otherwise copy every layer's whole cache) and return them.
  Sliding-window caches are ring buffers: RoPE is applied at write time
  with absolute positions.

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

MLA has no kernel, in the reference or here: it materialises the f32
(B, H, S, T) scores as the reference does (``impl`` is accepted and
ignored, as the reference's ``mla_full`` ignores it), and its q·k width
(nope + rope, 192 at full size) differs from v's (128), which the flash
kernel refuses.  The scores are masked in place (``masked_fill_``) where
the reference's ``where`` makes a copy: at DeepSeek-V3's full width one
(1, 128, 4,096, 4,096) f32 copy is 8.6 GB.  They run under the profiler
label ``MLA_SCORES``.

The plain paths' scores and probabilities pass through
``act_sharding.constrain_scores`` where the reference's do (a layout for a
DTensor under ``activation_sharding(mesh)``; a plain tensor unchanged).

On DTensors (a sharded step) ``_sdpa`` and MLA's scores-to-output run on
each rank's heads through ``sharded_heads.sdpa`` / ``sharded_heads.mla``
(the same code, plain or kernel, on local tensors), and the head
split / merge reshapes through ``sharded_heads.split_heads`` /
``merge_heads``.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import act_sharding, sharded_heads
from repro_torch.models.layers import (apply_rope, linear, linear_init, rmsnorm,
                                       rmsnorm_init, rope_angles)
from repro_torch.tree import PyTree

NEG_INF = -1e30
IMPLS = ("kernel", "plain")
MLA_SCORES = "mla_scores"   # profiler label: MLA's scores, mask, softmax and P·V


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             n: int | None = None) -> PyTree:
    hd = cfg.resolved_head_dim
    return {
        "wq": linear_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, device, n=n),
        "wk": linear_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device, n=n),
        "wv": linear_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device, n=n),
        "wo": linear_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, device, n=n),
    }


_split_heads = sharded_heads.split_heads


def _sdpa(q, k, v, mask, impl: str = "kernel", *, causal: bool = True,
          window: int = 0):
    """q: (B,S,H,D); k/v: (B,T,Hkv,D); mask: (B,S,T) or (S,T) bool, read by
    the plain path; the kernel takes ``causal`` / ``window`` instead.
    DTensor inputs run on each rank's heads (``sharded_heads.sdpa``)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if isinstance(q, DTensor):
        return sharded_heads.sdpa(
            lambda ql, kl, vl, ml: _sdpa(ql, kl, vl, ml, impl, causal=causal,
                                         window=window), q, k, v, mask,
            positions=impl == "plain" or q.shape[1] == 1 or not (causal or window))
    b, s, h, d = q.shape
    if impl == "kernel" and s > 1:
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    rep = h // k.shape[2]
    kr = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vr = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bshd,bthd->bhst", q, kr).float() * scale
    logits = act_sharding.constrain_scores(logits)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        logits = torch.where(m[:, None, :, :], logits,
                             torch.tensor(NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = act_sharding.constrain_scores(probs)
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
    y = linear(params["wo"], sharded_heads.merge_heads(y))
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
    y = linear(params["wo"], sharded_heads.merge_heads(y))
    return y, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             n: int | None = None) -> PyTree:
    h = cfg.num_heads
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p: PyTree = {}
    if cfg.q_lora_rank > 0:
        p["wq_a"] = linear_init(gen, cfg.d_model, cfg.q_lora_rank, dtype, device, n=n)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, device, n)
        p["wq_b"] = linear_init(gen, cfg.q_lora_rank, h * qk_dim, dtype, device, n=n)
    else:
        p["wq"] = linear_init(gen, cfg.d_model, h * qk_dim, dtype, device, n=n)
    p["wkv_a"] = linear_init(gen, cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                             dtype, device, n=n)
    p["kv_norm"] = rmsnorm_init(cfg.kv_lora_rank, dtype, device, n)
    p["wkv_b"] = linear_init(gen, cfg.kv_lora_rank,
                             h * (cfg.qk_nope_head_dim + cfg.v_head_dim), dtype, device, n=n)
    p["wo"] = linear_init(gen, h * cfg.v_head_dim, cfg.d_model, dtype, device, n=n)
    return p


def _mla_q(params: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if cfg.q_lora_rank > 0:
        q = linear(params["wq_b"], rmsnorm(params["q_norm"], linear(params["wq_a"], x)))
    else:
        q = linear(params["wq"], x)
    return _split_heads(q, cfg.num_heads, qk_dim)


def _mla_scores_and_out(params, cfg, q, c_kv, k_rope, mask):
    """q: (B,S,H,qk); c_kv: (B,T,rank); k_rope: (B,T,rope), shared across
    heads; mask: (B,S,T) or (S,T) bool.  DTensor inputs run the scores to
    P·V on each rank's heads (``sharded_heads.mla``)."""
    h = cfg.num_heads
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kv = _split_heads(linear(params["wkv_b"], rmsnorm(params["kv_norm"], c_kv)), h,
                      nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    if isinstance(q, DTensor):
        y = sharded_heads.mla(lambda *a: _mla_core(cfg, *a), q, k_nope, v, k_rope, mask)
    else:
        y = _mla_core(cfg, q, k_nope, v, k_rope, mask)
    return linear(params["wo"], sharded_heads.merge_heads(y))


def _mla_core(cfg, q, k_nope, v, k_rope, mask):
    """MLA's scores, mask, softmax and P·V: q (B,S,H,qk), k_nope (B,T,H,nope),
    v (B,T,H,vd), k_rope (B,T,rope) -> (B,S,H,vd)."""
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    scale = 1.0 / math.sqrt(nope + rope_d)
    with record_function(MLA_SCORES):
        logits = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshd,btd->bhst", q_rope, k_rope)).float()
        # in place from here (neither op's backward reads its output): at full
        # width each copy of the f32 scores would be B x 8.6 GB at S = T = 4,096
        logits.mul_(scale)
        logits = act_sharding.constrain_scores(logits)
        if mask is not None:
            m = mask if mask.dim() == 3 else mask[None]
            logits.masked_fill_(~m[:, None, :, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        del logits
        probs = act_sharding.constrain_scores(probs.to(q.dtype))
        return torch.einsum("bhst,bthd->bshd", probs, v)


def _mla_latents(params, cfg, x, positions):
    """Queries with RoPE on their rope part, and the latent cache entries
    ``c_kv`` and ``k_rope`` (RoPE applied) of the tokens ``x``."""
    q = _mla_q(params, cfg, x)
    ckr = linear(params["wkv_a"], x)
    c_kv, k_rope_raw = ckr[..., : cfg.kv_lora_rank], ckr[..., cfg.kv_lora_rank:]
    cos, sin = rope_angles(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    nope = cfg.qk_nope_head_dim
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)], dim=-1)
    k_rope = apply_rope(k_rope_raw[..., None, :], cos, sin)[..., 0, :]
    return q, c_kv, k_rope


def mla_full(
    params: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    impl: str = "kernel",
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (y, (c_kv, k_rope)): the compressed MLA cache of the
    sequence.  ``impl`` is checked and otherwise ignored (no kernel)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    q, c_kv, k_rope = _mla_latents(params, cfg, x, positions)
    mask = causal_mask(x.shape[1], window, x.device)
    y = _mla_scores_and_out(params, cfg, q, c_kv, k_rope, mask)
    return y, (c_kv, k_rope)


def mla_decode(
    params: PyTree,
    cfg: ModelConfig,
    x: torch.Tensor,
    c_cache: torch.Tensor,
    r_cache: torch.Tensor,
    pos: int,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token MLA decode against the latent cache.  x: (B,1,d);
    c_cache: (B,W,kv_rank), r_cache: (B,W,rope), written in place at the
    token's slot (``pos % W`` under a window, else ``pos``)."""
    b = x.shape[0]
    cache_len = c_cache.shape[1]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, c_kv, k_rope = _mla_latents(params, cfg, x, posv)
    slot = pos % cache_len if window > 0 else pos
    c_cache[:, slot:slot + 1] = c_kv.to(c_cache.dtype)
    r_cache[:, slot:slot + 1] = k_rope.to(r_cache.dtype)
    idx = torch.arange(cache_len, device=x.device)
    valid = torch.ones_like(idx, dtype=torch.bool) if pos + 1 >= cache_len else idx <= pos
    mask = valid[None, None, :].expand(b, 1, cache_len)
    y = _mla_scores_and_out(params, cfg, q, c_cache.to(x.dtype), r_cache.to(x.dtype), mask)
    return y, (c_cache, r_cache)
