"""The held experts' SwiGLU over grouped products as a function that
autograd and ``torch.func`` see through: ``_GroupedSwiGLU`` (the forward)
and ``_GroupedSwiGLUGrad`` (its backward), each a
``torch.autograd.Function`` over ``kernel.py`` with its own batching rule.

Every operand carries a leading client axis C.  Under ``torch.func.vmap``
(the vmap engine's cohort step, which vmaps each client's loss) the
batching rule folds the vmapped axis into C, so K clients × G groups run as
one launch of K·G groups, each client's group bounds its own: the rows a
client sends each expert differ from client to client, and stay on the
device.

The forward keeps only its inputs: the backward gathers the entries and
recomputes the gate and up products, so a layer holds no (entries, width)
tensor between its forward and its backward (at DeepSeek-V2-Lite's widths
the buffers of T·k rows would be ~0.95 GB a client step and MoE layer).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels.grouped_mm import kernel

MOE_EXPERTS = "moe_experts"   # models.moe's label of the expert products


def _fold(t, dim: int | None, size: int):
    """The vmapped axis ``dim`` (``None``: not vmapped, so broadcast) merged
    into the leading client axis; a non-tensor passes as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    t = t.movedim(dim, 0) if dim is not None else t.expand(size, *t.shape)
    return t.reshape(size * t.shape[1], *t.shape[2:])


def _unfold(t, size: int):
    return (None, None) if t is None else (t.reshape(size, -1, *t.shape[1:]), 0)


def _gather(xf: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """(C, T, d) tokens, (C, N) entries sorted by expert -> (C, N, d): each
    entry's token (entry ``e`` is token ``e // k``'s choice ``e % k``)."""
    clients = torch.arange(xf.shape[0], device=xf.device)[:, None]
    return xf[clients, order // k]


def _gate_up(x_in, ends, w_gate, w_up):
    return kernel.grouped_mm(x_in, w_gate, ends), kernel.grouped_mm(x_in, w_up, ends)


class _GroupedSwiGLUGrad(torch.autograd.Function):
    """The gradients of ``_GroupedSwiGLU`` for the inputs ``needs`` names
    (tokens, gate, up, down; ``None`` for the others); not differentiated
    again."""

    @staticmethod
    def forward(dy, xf, order, ends, w_gate, w_up, w_down, k, needs):
        x_in = _gather(xf, order, k)
        g, u = _gate_up(x_in, ends, w_gate, w_up)
        sg, a = torch.sigmoid(g), F.silu(g)
        dh = kernel.grouped_mm(dy, w_down.transpose(-1, -2), ends)
        dw_down = kernel.grouped_mm_wgrad(a * u, dy, ends) if needs[3] else None
        du = dh * a
        dg = dh * u * (sg * (1.0 + g * (1.0 - sg)))                  # silu'(g)
        del dh, a, sg, g, u
        dw_gate = kernel.grouped_mm_wgrad(x_in, dg, ends) if needs[1] else None
        dw_up = kernel.grouped_mm_wgrad(x_in, du, ends) if needs[2] else None
        dxf = None
        if needs[0]:
            dx_in = (kernel.grouped_mm(dg, w_gate.transpose(-1, -2), ends)
                     + kernel.grouped_mm(du, w_up.transpose(-1, -2), ends))
            # each token's k entries summed in a fixed order (no atomics)
            c, t, d = xf.shape
            dxf = dx_in.gather(1, torch.argsort(order, dim=1)[..., None].expand(-1, -1, d))
            dxf = dxf.reshape(c, t, k, d).sum(dim=2)
        return dxf, dw_gate, dw_up, dw_down

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the grouped SwiGLU's gradient is not differentiated again")

    @staticmethod
    def vmap(info, in_dims, *args):
        b = info.batch_size
        outs = _GroupedSwiGLUGrad.apply(*(_fold(t, d, b) for t, d in zip(args, in_dims)))
        unfolded = [_unfold(o, b) for o in outs]
        return tuple(o for o, _ in unfolded), tuple(d for _, d in unfolded)


class _GroupedSwiGLU(torch.autograd.Function):
    """``y[c, row] = (silu(x g) * (x u)) d`` with ``x`` the row's token,
    ``g``, ``u``, ``d`` its group's gate, up and down weights; rows in no
    group 0."""

    @staticmethod
    def forward(xf, order, ends, w_gate, w_up, w_down, k):
        g, u = _gate_up(_gather(xf, order, k), ends, w_gate, w_up)
        return kernel.grouped_mm(F.silu(g) * u, w_down, ends)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xf, order, ends, w_gate, w_up, w_down, k = inputs
        ctx.save_for_backward(xf, order, ends, w_gate, w_up, w_down)
        ctx.k = k

    @staticmethod
    def backward(ctx, dy):
        xf, order, ends, w_gate, w_up, w_down = ctx.saved_tensors
        n = ctx.needs_input_grad
        needs = (n[0], n[3], n[4], n[5])
        with record_function(MOE_EXPERTS):
            dxf, dwg, dwu, dwd = _GroupedSwiGLUGrad.apply(
                dy, xf, order, ends, w_gate, w_up, w_down, ctx.k, needs)
        return dxf, None, None, dwg, dwu, dwd, None

    @staticmethod
    def vmap(info, in_dims, *args):
        b = info.batch_size
        out = _GroupedSwiGLU.apply(*(_fold(t, d, b) for t, d in zip(args, in_dims)))
        return _unfold(out, b)


def grouped_swiglu(xf: torch.Tensor, order: torch.Tensor, ends: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   k: int) -> torch.Tensor:
    """The held experts' SwiGLU on the entries sorted by expert: ``xf`` (T,
    d) tokens, ``order`` (T·k,) the entries (``token·k + choice``) sorted by
    held expert, ``ends`` (G,) the groups' cumulative ends, ``w_gate`` /
    ``w_up`` (G, d, F), ``w_down`` (G, F, d) -> (T·k, d) each sorted entry's
    output, rows at or past ``ends[-1]`` zero.  Differentiable in ``xf`` and
    the weights, and vmappable."""
    return _GroupedSwiGLU.apply(xf[None], order[None], ends[None], w_gate[None], w_up[None],
                                w_down[None], k)[0]

