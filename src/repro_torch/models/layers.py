"""Foundational layers: norms, linear/embedding, MLPs, RoPE (port of
``repro.models.layers``).

Functional, as the reference: parameters are nested dicts of tensors with
the reference's keys and shapes (``(in, out)`` linear weights, ``x @ w``),
layer functions are pure.  Initialisers draw from an explicit
``torch.Generator`` on ``device`` (the reference's distributions; the
numbers differ from ``jax.random``'s).  Stacked initialisers take a leading
``n`` (the transformer's layer axis), or a tuple of them (the hybrid's
chunk and layer axes), as ``jax.vmap`` over keys gives.

``bf16_grad_barrier`` is not ported: it is the identity in the forward pass
and only casts each cotangent to its primal's dtype, which PyTorch's
autograd already does for every tensor (the train steps of
``launch.steps`` differentiate these layers; ``tests/test_torch_steps_bf16.py``
holds their bf16 gradients against the reference's).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import PyTree, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg) -> torch.dtype:
    """The dtype of a model config's parameters."""
    return _DTYPES[cfg.param_dtype]


def act_dtype(cfg) -> torch.dtype:
    """The dtype of a model config's activations."""
    return _DTYPES[cfg.activation_dtype]


def layer_slice(stack: PyTree | list[PyTree], i: int) -> PyTree:
    """Layer ``i`` of a stack: the ``[i]`` slices of a stacked tree, or item
    ``i`` of a list of per-layer trees."""
    if isinstance(stack, list):
        return stack[i]
    return tree_map(lambda a: a[i], stack)


def maybe_remat(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` its activations are recomputed in the
    backward instead of kept (non-reentrant ``torch.utils.checkpoint``; the
    recomputation repeats the same ops, so values and gradients are
    unchanged)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def stack_layers(trees: list[PyTree], lead: tuple[int, ...]) -> PyTree:
    """Stack same-structure trees on new leading axes ``lead``."""
    return tree_map(lambda *xs: torch.stack(xs).reshape(*lead, *xs[0].shape), *trees)


def _lead(n: int | tuple[int, ...] | None) -> tuple[int, ...]:
    if n is None:
        return ()
    return n if isinstance(n, tuple) else (n,)


def normal_init(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std²) of ``shape`` in ``dtype``, drawn one matrix (the last two
    axes) at a time, so the f32 draw never holds more than one layer's or
    one expert's matrix: a whole f32 draw of LLaVA-NeXT-34B's stacked
    (60, 7,168, 20,480) ``w_gate`` would be 35.2 GB.  A tensor without
    storage (the ``meta`` device, or a fake tensor: the dry run's shapes)
    is returned undrawn."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta or is_fake(out):
        return out
    for sub in out.reshape(-1, *shape[-2:]):
        sub.copy_(torch.randn(shape[-2:], generator=gen, device=device,
                              dtype=torch.float32).mul_(std))
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device, n: int | None = None) -> PyTree:
    return {"scale": torch.ones(_lead(n) + (d,), dtype=dtype, device=device)}


def rmsnorm(params: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_init(d: int, dtype, device, n: int | None = None) -> PyTree:
    return {"scale": torch.ones(_lead(n) + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(_lead(n) + (d,), dtype=dtype, device=device)}


def layernorm(params: PyTree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


def norm_init(kind: str, d: int, dtype, device, n: int | None = None) -> PyTree:
    if kind == "layernorm":
        return layernorm_init(d, dtype, device, n)
    return rmsnorm_init(d, dtype, device, n)


def norm_apply(kind: str, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    return layernorm(params, x) if kind == "layernorm" else rmsnorm(params, x)


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
                bias: bool = False, n: int | None = None) -> PyTree:
    p = {"w": normal_init(gen, _lead(n) + (d_in, d_out), 1.0 / math.sqrt(d_in),
                      dtype, device)}
    if bias:
        p["b"] = torch.zeros(_lead(n) + (d_out,), dtype=dtype, device=device)
    return p


def linear(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype,
                   device) -> PyTree:
    return {"table": normal_init(gen, (vocab, d), 0.02, dtype, device)}


def embed(params: PyTree, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    out = params["table"][ids]
    return out.to(dtype) if dtype is not None else out


def unembed(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Project back to vocab; computed in f32 for a stable softmax."""
    return x.float() @ params["table"].float().T


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, kind: str, d_model: int, d_ff: int, dtype,
             device, n: int | None = None) -> PyTree:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": linear_init(gen, d_model, d_ff, dtype, device, n=n),
            "w_up": linear_init(gen, d_model, d_ff, dtype, device, n=n),
            "w_down": linear_init(gen, d_ff, d_model, dtype, device, n=n),
        }
    if kind == "gelu":
        return {
            "w_in": linear_init(gen, d_model, d_ff, dtype, device, bias=True, n=n),
            "w_out": linear_init(gen, d_ff, d_model, dtype, device, bias=True, n=n),
        }
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_apply(params: PyTree, kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        g = F.silu(linear(params["w_gate"], x))
        return linear(params["w_down"], g * linear(params["w_up"], x))
    if kind == "geglu":
        g = F.gelu(linear(params["w_gate"], x), approximate="tanh")
        return linear(params["w_down"], g * linear(params["w_up"], x))
    if kind == "gelu":
        h = F.gelu(linear(params["w_in"], x), approximate="tanh")
        return linear(params["w_out"], h)
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_flops(kind: str, d_model: int, d_ff: int) -> int:
    """Matmul FLOPs per token (multiply-adds x2)."""
    mats = 3 if kind in ("swiglu", "geglu") else 2
    return 2 * mats * d_model * d_ff


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` — shapes (..., head_dim // 2)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves (x[:half], x[half:]), not interleaved pairs.
    x: (..., seq, heads, head_dim); cos/sin: (..., seq, half) broadcast over
    heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over head axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
