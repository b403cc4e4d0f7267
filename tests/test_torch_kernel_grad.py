"""The serving kernels have no backward, and say so instead of dropping
gradients.

The JAX package gives its flash-attention and SSD-chunk kernels no VJP, so
the port gives its CUDA kernels none either.  On a CUDA tensor the wrappers
write their outputs through raw pointers, so a gradient would vanish without
a word; they therefore refuse an input that requires grad while grad mode is
on, before the device dispatch, so the CPU (plain version) refuses exactly
as the card does.  Serving runs under ``torch.no_grad`` and is unchanged;
training differentiates ``impl="plain"``, which back-propagates.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
from repro_torch.models import attention, ssm

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)


def _attn_inputs(device="cpu"):
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 24, h, 32)), dtype=torch.float32,
                            device=device) for h in (4, 2, 2))
    return q, k, v


def _scan_inputs(device="cpu"):
    rng = np.random.default_rng(1)
    q, k = (torch.tensor(rng.standard_normal((1, 32, 2, 8)) * 0.3, dtype=torch.float32,
                         device=device) for _ in range(2))
    v = torch.tensor(rng.standard_normal((1, 32, 2, 16)), dtype=torch.float32,
                     device=device)
    la = torch.tensor(-0.2 * np.abs(rng.standard_normal((1, 32, 2))),
                      dtype=torch.float32, device=device)
    return q, k, v, la


def _wrappers():
    """(name, call, inputs) for the four wrappers without a backward."""
    def bhsd(fn):
        return lambda *xs, **kw: fn(*(x.transpose(1, 2) for x in xs), **kw)

    return [
        ("flash_attention_kernel", bhsd(flash_attention_kernel), _attn_inputs),
        ("ops.flash_attention", fa_ops.flash_attention, _attn_inputs),
        ("ssd_chunk_kernel", lambda *xs: bhsd(ssd_chunk_kernel)(*xs, chunk=16),
         _scan_inputs),
        ("ops.ssd_scan", lambda *xs: ssd_ops.ssd_scan(*xs, chunk=16), _scan_inputs),
    ]


def _assert_refusals(device):
    for name, call, make in _wrappers():
        for i in range(len(make(device))):
            xs = list(make(device))
            xs[i].requires_grad_(True)
            with pytest.raises(RuntimeError, match="no backward"):
                call(*xs)
            with torch.no_grad():
                out = call(*xs)
            first = out[0] if isinstance(out, tuple) else out
            assert first.grad_fn is None and bool(torch.isfinite(first).all()), name


def test_wrappers_refuse_grad_on_cpu():
    _assert_refusals("cpu")


def test_wrappers_run_without_grad():
    """No input requires grad: grad mode on or off, the wrappers serve."""
    for _, call, make in _wrappers():
        out = call(*make())
        first = out[0] if isinstance(out, tuple) else out
        assert bool(torch.isfinite(first).all())


def test_plain_attention_backpropagates_and_kernel_refuses():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = attention.gqa_init(torch.Generator().manual_seed(0), cfg,
                                torch.float32, "cpu")
    for leaf in params["wq"].values():
        leaf.requires_grad_(True)
    x = torch.tensor(np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)),
                     dtype=torch.float32)
    pos = torch.arange(16)[None].expand(2, 16)
    y, _ = attention.gqa_full(params, cfg, x, pos, impl="plain")
    y.square().sum().backward()
    g = params["wq"]["w"].grad
    assert g is not None and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    with pytest.raises(RuntimeError, match="impl='plain'"):
        attention.gqa_full(params, cfg, x, pos, impl="kernel")
    with torch.no_grad():
        yk, _ = attention.gqa_full(params, cfg, x, pos, impl="kernel")
        yp, _ = attention.gqa_full(params, cfg, x, pos, impl="plain")
    torch.testing.assert_close(yk, yp, rtol=1e-5, atol=1e-5)


def test_plain_scan_backpropagates_and_kernel_refuses():
    q, k, v, la = _scan_inputs()
    v.requires_grad_(True)
    y, _ = ssm.chunked_decay_attention(q, k, v, la, 16, impl="plain")
    y.square().sum().backward()
    assert bool(torch.isfinite(v.grad).all()) and float(v.grad.abs().max()) > 0
    with pytest.raises(RuntimeError, match="impl='plain'"):
        ssm.chunked_decay_attention(q, k, v, la, 16, impl="kernel")


@pytest.mark.gpu
def test_wrappers_refuse_grad_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _assert_refusals("cuda")
