"""State-space and recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM /
sLSTM) (port of ``repro.models.ssm``).

One chunked decay-weighted linear-attention engine implements the
recurrence

    S_t = a_t * S_{t-1} + k_t ⊗ v_t          y_t = q_t · S_t

Mamba2 (a = exp(-Δ·exp(A_log)), k = B, q = C, v = Δ·x) and the mLSTM (a =
σ(f), k, q from projections, v scaled by the clipped exponential input
gate; a second scan with v ≡ the gate gives the normaliser) both lower
onto it.  ``mamba2_forward`` and ``mlstm_forward`` run it one of two ways:

* ``impl="kernel"`` (the default): the hand-written CUDA SSD-chunk kernel
  (``kernels.ssd_chunk.ops.ssd_scan``); on CPU tensors that is its plain
  version, the sequential recurrence.  The kernel computes in f32 and
  returns an f32 state; it is cast to v's dtype for the cache, as the
  reference's jnp path leaves it, so cache layouts and dtypes are the same
  on both paths.  The mLSTM's two scans (N = P = 192 and P = 1 at
  xlstm-125m's widths) are two launches per layer.
* ``impl="plain"``: ``chunked_decay_attention``, the reference's jnp
  chunked form op for op (its casts included), with a Python loop over the
  chunks in place of ``jax.lax.scan``.

The sLSTM keeps its true sequential recurrence (h_{t-1} feeds the gates)
with the m-stabiliser: the reference's ``lax.scan`` over time is a Python
loop over time here, plain PyTorch (no TPU kernel runs it; XLA left it to
its fusion), under the profiler label ``SLSTM_LOOP``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models import sharded_heads
from repro_torch.models.layers import _lead, linear, linear_init, rmsnorm, rmsnorm_init
from repro_torch.tree import PyTree

IMPLS = ("kernel", "plain")
SLSTM_LOOP = "slstm_time_loop"   # profiler label of the sLSTM's loop over time


# ---------------------------------------------------------------------------
# Generic chunked decay attention
# ---------------------------------------------------------------------------

def chunked_decay_attention(
    q: torch.Tensor,        # (B, S, H, N)
    k: torch.Tensor,        # (B, S, H, N)
    v: torch.Tensor,        # (B, S, H, P)
    log_a: torch.Tensor,    # (B, S, H) — per-step decay logs, <= 0
    chunk: int,
    init_state: torch.Tensor | None = None,   # (B, H, N, P)
    *,
    impl: str = "plain",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,S,H,P), final_state: (B,H,N,P)).

    ``impl="plain"`` is the reference's chunked form; ``impl="kernel"``
    runs the SSD-chunk kernel, which starts from a zero state, so an
    ``init_state`` there raises (the reference's kernel has none either).
    The causal mask is a select where the reference multiplies by it: the
    two agree wherever the reference is finite, and above the diagonal
    ``exp(cum_i − cum_j)`` can overflow, which the multiply turns into NaN.
    The select is made on the exponent (−inf above the diagonal), so the
    backward never meets the overflow either: a select on ``exp``'s output
    would pass its zero gradient through ``exp``'s inf as NaN.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if isinstance(q, DTensor):
        if init_state is not None:
            raise ValueError("a DTensor scan starts from a zero state")
        return sharded_heads.scan(
            lambda *a: chunked_decay_attention(*a, chunk, impl=impl), q, k, v, log_a)
    if impl == "kernel":
        if init_state is not None:
            raise ValueError("the SSD-chunk kernel starts from a zero state; "
                             "init_state needs impl='plain'")
        return ssd_ops.ssd_scan(q, k, v, log_a, chunk=chunk)
    b, s, h, n = q.shape
    p = v.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk

    def to_chunks(x):
        return x.reshape(b, nc, chunk, *x.shape[2:])

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    la = to_chunks(log_a).float()                              # (b,nc,Q,h)
    cum = torch.cumsum(la, dim=2)                              # inclusive
    total = cum[:, :, -1:, :]                                  # (b,nc,1,h)

    # Intra-chunk: scores[i,j] = (q_i·k_j)·exp(cum_i − cum_j), causal i>=j.
    qk = torch.einsum("bcqhn,bcthn->bcqth", qc, kc)
    ar = torch.arange(chunk, device=q.device)
    causal = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    decay = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :])
                      .masked_fill(~causal, -math.inf))        # (b,c,q,t,h)
    w = qk.float() * decay
    y_intra = torch.einsum("bcqth,bcthp->bcqhp", w.to(v.dtype), vc)

    # Per-chunk state contribution: S_c = Σ_t exp(total − cum_t)·k_t ⊗ v_t
    kw = kc.float() * torch.exp(total - cum)[..., None]
    s_c = torch.einsum("bcthn,bcthp->bchnp", kw.to(v.dtype), vc)

    # Inter-chunk recurrence over nc (only the state crosses chunks).
    a_tot = torch.exp(total[:, :, 0, :])                       # (b,nc,h)
    carry = (init_state if init_state is not None
             else torch.zeros((b, h, n, p), dtype=v.dtype, device=v.device))
    prevs = []
    for c in range(nc):
        prevs.append(carry)
        carry = a_tot[:, c, :, None, None].to(carry.dtype) * carry + s_c[:, c]
    s_prev = torch.stack(prevs, dim=1)                         # (b,nc,h,n,p)

    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", qc, s_prev,
                           torch.exp(cum).to(v.dtype))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, carry


def decay_attention_step(
    q: torch.Tensor,        # (B, H, N)
    k: torch.Tensor,        # (B, H, N)
    v: torch.Tensor,        # (B, H, P)
    a: torch.Tensor,        # (B, H) decay in (0,1]
    state: torch.Tensor,    # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence (decode): O(H·N·P) per step.  DTensor
    inputs run on each rank's heads (``sharded_heads.head_parallel``)."""
    if isinstance(state, DTensor):
        return sharded_heads.head_parallel(
            lambda st, *qkva: decay_attention_step(*qkva, st), (state, q, k, v, a),
            ((0, 1),) * 5, ((0, 1), (0, 1)), state.shape[1])
    new_state = a[..., None, None] * state + k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", q, new_state)
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    hdim = cfg.ssm_head_dim or 64
    heads = cfg.ssm_num_heads or d_inner // hdim
    n = cfg.ssm_state_dim or 64
    return d_inner, heads, hdim, n


CONV_W = 4  # causal depthwise conv width


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                n: int | tuple[int, ...] | None = None) -> PyTree:
    """One Mamba2 block's params (the reference's distributions), or blocks
    stacked on leading axes ``n`` (an int or a tuple of them)."""
    d_inner, heads, hdim, ns = _mamba_dims(cfg)
    conv_dim = d_inner + 2 * ns
    proj_out = 2 * d_inner + 2 * ns + heads   # z, x, B, C, dt
    lead = _lead(n)
    in_proj = linear_init(gen, cfg.d_model, proj_out, dtype, device, n=n)
    conv_w = torch.randn(lead + (CONV_W, conv_dim), generator=gen, device=device,
                         dtype=torch.float32)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.mul_(0.2).to(dtype),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        # A = -exp(a_log) = -1; softplus(dt_bias) ≈ 0.12
        "a_log": torch.zeros(lead + (heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.full(lead + (heads,), -2.0, dtype=torch.float32,
                              device=device),
        "d_skip": torch.ones(lead + (heads,), dtype=dtype, device=device),
        "out_norm": rmsnorm_init(d_inner, dtype, device, n),
        "out_proj": linear_init(gen, d_inner, cfg.d_model, dtype, device, n=n),
    }


def _pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zero positions ahead of dim 1 of (B, S, C) ``x``."""
    return sharded_heads.pad(x, [0, 0, n, 0], (1,))


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  seq: (B,S,C); w: (W,C)."""
    width = w.shape[0]
    pad = _pad_front(seq, width - 1)
    out = torch.zeros_like(seq)
    for i in range(width):
        out = out + pad[:, i:i + seq.shape[1], :] * w[i]
    return out + b


def _mamba_heads(xbc: torch.Tensor, d_inner: int, n: int):
    xs = xbc[..., :d_inner]
    bmat = xbc[..., d_inner:d_inner + n]
    cmat = xbc[..., d_inner + n:]
    return xs, bmat, cmat


def mamba2_forward(
    params: PyTree, cfg: ModelConfig, x: torch.Tensor, *, impl: str = "kernel",
) -> tuple[torch.Tensor, PyTree]:
    """Full-sequence Mamba2.  Returns (y, cache) where cache holds the final
    SSM state (v's dtype) and the conv tail (for decode)."""
    b, s, _ = x.shape
    d_inner, heads, hdim, n = _mamba_dims(cfg)
    zxbcdt = linear(params["in_proj"], x)
    z = zxbcdt[..., :d_inner]
    xbc_in = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt_raw = zxbcdt[..., -heads:]

    xbc = F.silu(_causal_conv(xbc_in, params["conv_w"].to(x.dtype),
                              params["conv_b"].to(x.dtype)))
    xs, bmat, cmat = _mamba_heads(xbc, d_inner, n)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])                    # (b,s,h)
    a = -torch.exp(params["a_log"])                                        # (h,)
    log_decay = dt * a                                                     # <= 0
    xh = sharded_heads.split_heads(xs, heads, hdim)
    v = xh * dt[..., None].to(x.dtype)
    # head-broadcast views (head stride 0): the kernel reads them in place
    k = bmat[:, :, None, :].expand(b, s, heads, n)
    q = cmat[:, :, None, :].expand(b, s, heads, n)

    y, state = chunked_decay_attention(q, k, v, log_decay, cfg.ssm_chunk, impl=impl)
    state = state.to(v.dtype)
    y = y + xh * params["d_skip"].to(x.dtype)[None, None, :, None]
    y = sharded_heads.merge_heads(y)
    y = rmsnorm(params["out_norm"], y * F.silu(z))
    y = linear(params["out_proj"], y)
    # the last W-1 pre-conv inputs, zero-padded in front for a short prompt;
    # a copy, so the cache does not hold the whole projection alive
    tail = xbc_in[:, -(CONV_W - 1):, :]
    conv = _pad_front(tail, CONV_W - 1 - tail.shape[1]).contiguous()
    return y, {"state": state, "conv": conv}


def mamba2_decode(
    params: PyTree, cfg: ModelConfig, x: torch.Tensor, cache: PyTree
) -> tuple[torch.Tensor, PyTree]:
    """One-token step.  x: (B,1,d); cache: {state (b,h,n,p), conv (b,W-1,c)};
    returns new cache tensors."""
    b = x.shape[0]
    d_inner, heads, hdim, n = _mamba_dims(cfg)
    zxbcdt = linear(params["in_proj"], x)
    z = zxbcdt[..., :d_inner]
    xbc_new = zxbcdt[:, 0, d_inner:2 * d_inner + 2 * n]                   # (b,c)
    dt_raw = zxbcdt[..., -heads:]

    conv_in = torch.cat([cache["conv"], xbc_new[:, None, :]], dim=1)      # (b,W,c)
    w = params["conv_w"].to(x.dtype)
    xbc = F.silu(torch.einsum("bwc,wc->bc", conv_in, w)
                 + params["conv_b"].to(x.dtype))
    xs, bmat, cmat = _mamba_heads(xbc, d_inner, n)

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])             # (b,h)
    a = torch.exp(dt * -torch.exp(params["a_log"]))
    xh = sharded_heads.split_heads(xs, heads, hdim)
    v = xh * dt[..., None].to(x.dtype)
    k = bmat[:, None, :].expand(b, heads, n)
    q = cmat[:, None, :].expand(b, heads, n)
    y, state = decay_attention_step(q, k, v, a.to(x.dtype), cache["state"])
    y = y + xh * params["d_skip"].to(x.dtype)[None, :, None]
    y = sharded_heads.merge_heads(y)[:, None]
    y = rmsnorm(params["out_norm"], y * F.silu(z))
    y = linear(params["out_proj"], y)
    return y, {"state": state, "conv": conv_in[:, 1:, :]}


def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                      n: int | tuple[int, ...] | None = None) -> PyTree:
    """A zero Mamba2 cache, or caches stacked on leading axes ``n``."""
    d_inner, heads, hdim, ns = _mamba_dims(cfg)
    lead = _lead(n)
    return {
        "state": torch.zeros(lead + (batch, heads, ns, hdim), dtype=dtype, device=device),
        "conv": torch.zeros(lead + (batch, CONV_W - 1, d_inner + 2 * ns), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    hdim = cfg.ssm_head_dim or 64
    return d_inner, d_inner // hdim, hdim


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               n: int | tuple[int, ...] | None = None) -> PyTree:
    """One mLSTM block's params (the reference's distributions), or blocks
    stacked on leading axes ``n``."""
    d = cfg.d_model
    d_inner, heads, _ = _mlstm_dims(cfg)
    return {
        "up_proj": linear_init(gen, d, 2 * d_inner, dtype, device, n=n),   # x-branch, z-gate
        "wq": linear_init(gen, d_inner, d_inner, dtype, device, n=n),
        "wk": linear_init(gen, d_inner, d_inner, dtype, device, n=n),
        "wv": linear_init(gen, d_inner, d_inner, dtype, device, n=n),
        "w_i": linear_init(gen, d_inner, heads, dtype, device, bias=True, n=n),
        "w_f": linear_init(gen, d_inner, heads, dtype, device, bias=True, n=n),
        "out_norm": rmsnorm_init(d_inner, dtype, device, n),
        "down_proj": linear_init(gen, d_inner, d, dtype, device, n=n),
    }


def _mlstm_qkv(params: PyTree, cfg: ModelConfig, xb: torch.Tensor):
    d_inner = xb.shape[-1]
    hdim = cfg.ssm_head_dim or 64
    heads = d_inner // hdim
    q = sharded_heads.split_heads(linear(params["wq"], xb), heads, hdim)
    # the reference divides by sqrt(hdim) taken in f32, cast to x's dtype
    scale = float(torch.tensor(math.sqrt(hdim), dtype=torch.float32).to(xb.dtype))
    k = sharded_heads.split_heads(linear(params["wk"], xb), heads, hdim) / scale
    v = sharded_heads.split_heads(linear(params["wv"], xb), heads, hdim)
    i_raw = linear(params["w_i"], xb).float()
    f_raw = linear(params["w_f"], xb).float()
    return q, k, v, i_raw, f_raw, heads


def mlstm_forward(
    params: PyTree, cfg: ModelConfig, x: torch.Tensor, *, impl: str = "kernel",
) -> tuple[torch.Tensor, PyTree]:
    """Full-sequence mLSTM.  The exponential input gate is clipped
    (``exp(min(i, 8))``) as the reference clips it, which keeps the chunked
    forward consistent with the recurrent decode.  Returns (y, cache) with
    the final value and normaliser states in v's dtype."""
    b, s, _ = x.shape
    up = linear(params["up_proj"], x)
    d_inner = up.shape[-1] // 2
    xb, z = up[..., :d_inner], up[..., d_inner:]
    q, k, v, i_raw, f_raw, heads = _mlstm_qkv(params, cfg, xb)
    i_gate = torch.exp(torch.clamp_max(i_raw, 8.0))                # (b,s,h)
    log_f = (sharded_heads.pointwise(F.logsigmoid, f_raw) if isinstance(f_raw, DTensor)
             else F.logsigmoid(f_raw))                              # <= 0
    v_scaled = v * i_gate[..., None].to(v.dtype)
    y, state = chunked_decay_attention(q, k, v_scaled, log_f, cfg.ssm_chunk, impl=impl)
    # normaliser: the same recurrence with v ≡ the input gate (P = 1)
    ones = i_gate[..., None].to(v.dtype)                            # (b,s,h,1)
    norm, n_state = chunked_decay_attention(q, k, ones, log_f, cfg.ssm_chunk, impl=impl)
    denom = torch.clamp_min(norm[..., 0].abs(), 1.0)[..., None]
    h = sharded_heads.merge_heads(y / denom)
    h = rmsnorm(params["out_norm"], h) * F.silu(z)
    out = linear(params["down_proj"], h)
    return out, {"state": state.to(v.dtype), "n_state": n_state.to(v.dtype)}


def mlstm_decode(
    params: PyTree, cfg: ModelConfig, x: torch.Tensor, cache: PyTree
) -> tuple[torch.Tensor, PyTree]:
    """One-token step.  x: (B,1,d); cache: {state (b,h,P,P), n_state
    (b,h,P,1)}; returns new cache tensors."""
    b = x.shape[0]
    up = linear(params["up_proj"], x)
    d_inner = up.shape[-1] // 2
    xb, z = up[:, 0, :d_inner], up[:, 0, d_inner:]
    q, k, v, i_raw, f_raw, heads = _mlstm_qkv(params, cfg, xb)
    i_gate = torch.exp(torch.clamp_max(i_raw, 8.0))
    f_gate = torch.sigmoid(f_raw).to(v.dtype)
    v_scaled = v * i_gate[..., None].to(v.dtype)
    y, state = decay_attention_step(q, k, v_scaled, f_gate, cache["state"])
    ones = i_gate[..., None].to(v.dtype)                            # (b,h,1)
    norm, n_state = decay_attention_step(q, k, ones, f_gate, cache["n_state"])
    denom = torch.clamp_min(norm[..., 0].abs(), 1.0)[..., None]
    h = sharded_heads.merge_heads(y / denom)[:, None]
    h = rmsnorm(params["out_norm"], h) * F.silu(z)[:, None, :]
    out = linear(params["down_proj"], h)
    return out, {"state": state, "n_state": n_state}


def mlstm_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                     n: int | tuple[int, ...] | None = None) -> PyTree:
    """A zero mLSTM cache, or caches stacked on leading axes ``n``."""
    _, heads, hdim = _mlstm_dims(cfg)
    lead = _lead(n)
    return {
        "state": torch.zeros(lead + (batch, heads, hdim, hdim), dtype=dtype, device=device),
        "n_state": torch.zeros(lead + (batch, heads, hdim, 1), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM block (true recurrence, a Python loop over time)
# ---------------------------------------------------------------------------

M_INIT = -30.0   # the m-stabiliser's starting value (the reference's)


def _slstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    hdim = cfg.ssm_head_dim or 64
    return cfg.d_model // hdim, hdim


def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               n: int | tuple[int, ...] | None = None) -> PyTree:
    """One sLSTM block's params: 4 gates (z, i, f, o), input weights and
    block-diagonal recurrent weights per head; or blocks stacked on ``n``."""
    d = cfg.d_model
    heads, hdim = _slstm_dims(cfg)
    r_h = torch.randn(_lead(n) + (heads, hdim, 4 * hdim), generator=gen, device=device,
                      dtype=torch.float32)
    return {
        "w_x": linear_init(gen, d, 4 * d, dtype, device, bias=True, n=n),
        "r_h": r_h.mul_(1.0 / math.sqrt(hdim)).to(dtype),
        "out_norm": rmsnorm_init(d, dtype, device, n),
        "out_proj": linear_init(gen, d, d, dtype, device, n=n),
    }


def slstm_forward(
    params: PyTree, cfg: ModelConfig, x: torch.Tensor, init: tuple | None = None
) -> tuple[torch.Tensor, tuple]:
    """Sequential sLSTM with the exp-gating m-stabiliser.  x: (B,S,d).
    Returns (y, (c, n, h, m)): c, n, h in x's dtype, m in f32, as the
    reference casts them.  On DTensors the loop over time runs on each
    rank's heads (``sharded_heads.head_parallel``: the recurrent weights
    are per head, block-diagonal)."""
    b, s, d = x.shape
    heads, hdim = _slstm_dims(cfg)
    gx = linear(params["w_x"], x)                                   # (b,s,4d)
    r_h = params["r_h"].to(x.dtype)
    if isinstance(gx, DTensor):
        state_dims = ((0, 1),) * 4
        if init is None:
            y, *state = sharded_heads.head_parallel(
                lambda g, r: _slstm_loop(g, r, None, heads, hdim), (gx, r_h),
                ((0, 2), (None, 0)), ((0, 2),) + state_dims, heads)
        else:
            y, *state = sharded_heads.head_parallel(
                lambda g, r, *st: _slstm_loop(g, r, st, heads, hdim), (gx, r_h, *init),
                ((0, 2), (None, 0)) + state_dims, ((0, 2),) + state_dims, heads)
        state = tuple(state)
    else:
        y, *state = _slstm_loop(gx, r_h, init, heads, hdim)
        state = tuple(state)
    y = linear(params["out_proj"], rmsnorm(params["out_norm"], y))
    return y, state


def _slstm_loop(gx: torch.Tensor, r_h: torch.Tensor, init: tuple | None, heads: int,
                hdim: int) -> tuple:
    """The recurrence over time of ``gx`` (b, s, heads * 4 * hdim, head
    major) with per-head recurrent weights ``r_h`` (heads, hdim, 4 * hdim):
    returns (y (b, s, heads * hdim), c, n, h, m); ``heads`` is the local
    count (``gx``'s own)."""
    b, s = gx.shape[:2]
    heads = r_h.shape[0]
    c, n, h, m = init if init is not None else slstm_cache_init_shapes(
        b, heads, hdim, gx.dtype, gx.device)
    hs = []
    with record_function(SLSTM_LOOP):
        # one unbind over time, not a ``gx[:, t]`` slice a step: each slice's
        # backward would write a zero-filled (b, s, 4d) gradient (O(S^2) bytes)
        for gx_t in gx.unbind(1):
            rec = torch.einsum("bhp,hpq->bhq", h, r_h)              # (b,heads,4*hdim)
            g = gx_t.reshape(b, heads, 4, hdim) + rec.reshape(b, heads, 4, hdim)
            z_t = torch.tanh(g[:, :, 0])
            i_t = g[:, :, 1].float()
            f_t = g[:, :, 2].float()
            o_t = torch.sigmoid(g[:, :, 3])
            log_f = F.logsigmoid(f_t)
            m_new = torch.maximum(log_f + m, i_t)
            i_p = torch.exp(i_t - m_new).to(gx.dtype)
            f_p = torch.exp(log_f + m - m_new).to(gx.dtype)
            c = f_p * c + i_p * z_t
            n = f_p * n + i_p
            h = o_t * c / torch.clamp_min(n.abs(), 1.0)
            m = m_new
            hs.append(h)
    return torch.stack(hs, dim=1).reshape(b, s, heads * hdim), c, n, h, m


def slstm_decode(
    params: PyTree, cfg: ModelConfig, x: torch.Tensor, cache: tuple
) -> tuple[torch.Tensor, tuple]:
    return slstm_forward(params, cfg, x, init=cache)


def slstm_cache_init_shapes(b: int, heads: int, hdim: int, dtype, device,
                            lead: tuple[int, ...] = ()) -> tuple:
    """Zero (c, n, h) in ``dtype`` and m at ``M_INIT`` in f32: four
    separate tensors (decode writes them in place)."""
    shape = lead + (b, heads, hdim)
    z = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(3)]
    return (*z, torch.full(shape, M_INIT, dtype=torch.float32, device=device))


def slstm_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                     n: int | tuple[int, ...] | None = None) -> tuple:
    """A fresh sLSTM cache, or caches stacked on leading axes ``n``."""
    heads, hdim = _slstm_dims(cfg)
    return slstm_cache_init_shapes(batch, heads, hdim, dtype, device, _lead(n))
