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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
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


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor that is a pending sum (``Partial``: the vocab-parallel
    embedding's rows, a row-parallel linear's output, summed along the
    residual stream) reduced to ``Replicate`` there: one all-reduce a
    sublayer, where Megatron (and GSPMD on the reference) reduces.  Left
    pending, DTensor's propagation reduce-scatters the stream over the
    batch on "model" and all-gathers every weight of the next linears."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in x.placements])
    return x


class _ReducePartialGrad(torch.autograd.Function):
    """The identity, whose backward reduces a pending-sum gradient: at a
    norm's output, where the tensor-parallel linears' input gradients come
    back as partial sums, one all-reduce a sublayer (Megatron's backward
    one); left pending, DTensor's propagation all-gathers the weights of
    the linears before."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def _norm_out(y: torch.Tensor) -> torch.Tensor:
    if isinstance(y, DTensor) and y.requires_grad:
        return _ReducePartialGrad.apply(y)
    return y


def _norm_param(w: torch.Tensor) -> torch.Tensor:
    """A norm's (d,) scale or bias, replicated where the rules shard it (an
    all-gather of d values, as GSPMD gathers it).  Left sharded over
    "model", DTensor lays the normed stream out to match it, and the next
    linears then all-gather their weights."""
    if isinstance(w, DTensor) and any(isinstance(p, Shard) for p in w.placements):
        return w.redistribute(w.device_mesh, [Replicate() if isinstance(p, Shard) else p
                                              for p in w.placements])
    return w


def rmsnorm(params: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x = reduce_partial(x)
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return _norm_out((y * _norm_param(params["scale"]).float()).to(dt))


def layernorm_init(d: int, dtype, device, n: int | None = None) -> PyTree:
    return {"scale": torch.ones(_lead(n) + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(_lead(n) + (d,), dtype=dtype, device=device)}


def layernorm(params: PyTree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = reduce_partial(x)
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * _norm_param(params["scale"]).float() + _norm_param(params["bias"]).float()
    return _norm_out(y.to(dt))


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
    """Rows ``ids`` of the table (a DTensor table: ``_embed_sharded``)."""
    table = params["table"]
    out = _embed_sharded(table, ids) if isinstance(table, DTensor) else table[ids]
    return out.to(dtype) if dtype is not None else out


def _embed_sharded(table: DTensor, ids) -> DTensor:
    """The lookup on each rank's block of a DTensor table, as GSPMD
    partitions it: where the vocabulary is sharded, each rank looks up the
    ids in its slice, zeroes the others, and the (B, S, d) rows are a
    partial sum over that mesh dim (reduced where they are next used);
    where d is sharded the rows are too.  The ids keep their batch layout
    elsewhere.  The backward is the local lookup's, so the table's gradient
    comes back in its own layout (a partial sum over a data axis that
    shards the ids).  DTensor's own rules for the indexing do not serve: its
    backward (``index_put``) has none that runs on some torch versions, and
    ``F.embedding``'s masked output is refused by a later norm."""
    from repro_torch.models import sharded_heads

    mesh = table.device_mesh
    ids = sharded_heads.on_mesh(ids, mesh)
    vocab, v_loc = table.shape[0], table.to_local().shape[0]
    v_off = sharded_heads.offsets(table, table.placements)[0]
    id_pl, out_pl, grad_pl = [], [], []
    for tp, ip in zip(table.placements, ids.placements):
        if isinstance(tp, Shard):
            id_pl.append(Replicate())
            out_pl.append(Partial() if tp.dim == 0 else Shard(ids.ndim))
            grad_pl.append(tp)
        else:
            batch = isinstance(ip, Shard) and ip.dim == 0
            id_pl.append(Shard(0) if batch else Replicate())
            out_pl.append(Shard(0) if batch else Replicate())
            grad_pl.append(Partial() if batch else Replicate())

    def lookup(t, i):
        if v_loc == vocab:
            return t[i]
        local = i - v_off
        inside = (local >= 0) & (local < v_loc)
        return t[local.clamp(0, v_loc - 1)] * inside[..., None].to(t.dtype)

    return local_map(lookup, out_placements=out_pl, in_placements=(list(table.placements),
                                                                   id_pl),
                     in_grad_placements=(grad_pl, id_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


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
