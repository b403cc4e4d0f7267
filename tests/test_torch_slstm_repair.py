"""The sLSTM loop's one unbind over time (``models/ssm.py``
``slstm_forward``): each step used to slice ``gx[:, t]``, and each slice's
backward wrote a zero-filled (B, S, 4d) gradient, so the xLSTM train
step's bytes grew with S².

* The forward values and every gradient (params and input) are bit-equal
  to the slicing loop's, which this file keeps as it was, in f32 and bf16.
* Against the reference's ``repro.models.ssm.slstm_forward`` on the same
  params and input, y and the (c, n, h, m) state within
  ``test_torch_xlstm.py``'s tolerances (1e-4 for y, 1e-5 for the state,
  absolute plus relative).
* The dry run's op bytes for the smoke xLSTM train step at B 2
  (``dryrun._trace_at`` on one rank) grow by a near-constant amount per 16
  positions: at S 32, 48, 64 and 80 the increments differ by at most 1 MB
  (0.54 MB measured; 8-9 MB with the slicing loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import ssm
from repro_torch.models.api import InputShape
from repro_torch.models.layers import linear, rmsnorm

torch.set_num_threads(1)


def _slicing_loop(params, cfg, x):
    """``slstm_forward`` as it was: ``gx[:, t]`` sliced at each step."""
    b, s, d = x.shape
    heads, hdim = ssm._slstm_dims(cfg)
    gx = linear(params["w_x"], x)
    c, n, h, m = ssm.slstm_cache_init_shapes(b, heads, hdim, x.dtype, x.device)
    r_h = params["r_h"].to(x.dtype)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhp,hpq->bhq", h, r_h)
        g = gx[:, t].reshape(b, heads, 4, hdim) + rec.reshape(b, heads, 4, hdim)
        z_t = torch.tanh(g[:, :, 0])
        i_t = g[:, :, 1].float()
        f_t = g[:, :, 2].float()
        o_t = torch.sigmoid(g[:, :, 3])
        log_f = F.logsigmoid(f_t)
        m_new = torch.maximum(log_f + m, i_t)
        i_p = torch.exp(i_t - m_new).to(x.dtype)
        f_p = torch.exp(log_f + m - m_new).to(x.dtype)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.clamp_min(n.abs(), 1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d)
    y = linear(params["out_proj"], rmsnorm(params["out_norm"], y))
    return y, (c, n, h, m)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("xlstm-125m", smoke=True)
    params = jax.tree.map(np.asarray, jssm.slstm_init(jax.random.key(0), jcfg,
                                                      jnp.float32))
    x = np.random.default_rng(1).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, params, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_values_and_gradients_bit_equal_to_slicing_loop(setup, dtype):
    _, params, x = setup
    cfg = get_config("xlstm-125m", smoke=True)
    out = []
    for fn in (ssm.slstm_forward, _slicing_loop):
        p = _cast(bridge.from_numpy_tree(params), dtype)
        leaves = [t.requires_grad_(True) for t in _leaves(p)]
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        y, state = fn(p, cfg, xt)
        grads = torch.autograd.grad((y.float() ** 2).sum(), leaves + [xt])
        out.append((y.detach(), [s.detach() for s in state], grads))
    (y0, s0, g0), (y1, s1, g1) = out
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def _leaves(tree):
    return [t for k in sorted(tree) for t in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def test_matches_reference(setup):
    jcfg, params, x = setup
    y_j, state_j = jssm.slstm_forward(params, jcfg, jnp.asarray(x))
    y, state = ssm.slstm_forward(bridge.from_numpy_tree(params),
                                 get_config("xlstm-125m", smoke=True), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-4)
    for a, b in zip(state, state_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_train_op_bytes_grow_linearly():
    cfg = get_config("xlstm-125m", smoke=True)
    vals = [dryrun._trace_at(cfg, InputShape("t", s, 2, "train"), MeshShape((1, 1)),
                             peak=False)[0].op_bytes for s in (32, 48, 64, 80)]
    inc = [b - a for a, b in zip(vals, vals[1:])]
    assert all(abs(b - a) <= 1e6 for a, b in zip(inc, inc[1:])), inc
