"""The port's ``models/moe.py`` against the JAX package's ``models/moe.py``.

On the two smoke MoE configs with the reference's params
(``moe_init(jax.random.key(seed))``) bridged and numpy inputs:

* ``moe_init``: the reference's tree, shapes and dtypes (one layer and a
  stacked one);
* ``moe_apply`` in f32: DeepSeek-V3's sigmoid router with top-2 and a
  shared expert, Llama-4's softmax router with top-1 and a shared expert
  (their smoke configs; ``tests/test_torch_configs.py`` holds those equal
  to the reference's); y and the aux loss;
* ``capacity_factor`` 0.5, where tokens are dropped (checked to drop);
* the tie case: a zero router weight makes every score equal, and both
  packages then pick experts ``0..k-1`` for every token (``jax.lax.top_k``'s
  rule, which ``_top_k`` keeps and ``torch.topk`` does not promise);
* bf16 params and activations;
* gradients of ``sum(y) + aux`` against ``jax.grad`` (params and x);
* ``_capacity`` and ``moe_flops_per_token`` equal.

Tolerances: f32 y and aux ≤ 1e-5 (abs + rel; sums in another order);
gradients ≤ 1e-4; bf16 ≤ 2e-2 (one bf16 rounding of y in another order);
expert choices and integers exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
ARCHS = ["deepseek-v3-671b", "llama4-maverick-400b-a17b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return bridge.from_numpy_tree({"x": np.asarray(a)})["x"]


def _setup(arch, seed=0, dtype="float32", **kw):
    cfg = j_get_config(arch, smoke=True).with_(param_dtype=dtype, activation_dtype=dtype,
                                               **kw)
    params = _np(jmoe.moe_init(jax.random.key(seed), cfg, jnp.dtype(dtype)))
    x = np.random.default_rng(seed + 1).standard_normal((2, 16, cfg.d_model))
    x = jnp.asarray(x.astype(np.float32)).astype(dtype)
    return cfg, params, np.asarray(x)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [None, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_has_the_reference_tree(arch, n):
    cfg = j_get_config(arch, smoke=True).with_(param_dtype="bfloat16")
    if n is None:
        jtree = jax.eval_shape(lambda: jmoe.moe_init(jax.random.key(0), cfg, jnp.bfloat16))
    else:
        jtree = jax.eval_shape(lambda: jax.vmap(
            lambda k: jmoe.moe_init(k, cfg, jnp.bfloat16))(jax.random.split(jax.random.key(0), n)))
    ttree = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu", n)
    jflat, tflat = tree_paths(jtree), tree_paths(ttree)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16, path
    # the experts' draws have the reference's scale: std 1/sqrt(d), 1/sqrt(F)
    ew = ttree["experts"]
    assert abs(float(ew["w_gate"].float().std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(ew["w_down"].float().std()) * cfg.moe_d_ff ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch):
    cfg, params, x = _setup(arch)
    jy, jaux = jmoe.moe_apply(params, cfg, x)
    y, aux = moe.moe_apply(bridge.from_numpy_tree(params), cfg, _t(x))
    assert y.shape == x.shape and y.dtype == torch.float32 and aux.dtype == torch.float32
    _close(y, jy, TOL)
    _close(aux, jaux, TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch):
    cfg, params, x = _setup(arch, seed=2, capacity_factor=0.5)
    t = x.shape[0] * x.shape[1]
    cap = moe._capacity(t, cfg)
    _, _, idx = moe.route(bridge.from_numpy_tree(params), cfg, _t(x.reshape(t, -1)))
    per_expert = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    assert int(per_expert.max()) > cap        # some entries go to the sentinel
    jy, jaux = jmoe.moe_apply(params, cfg, x)
    y, aux = moe.moe_apply(bridge.from_numpy_tree(params), cfg, _t(x))
    _close(y, jy, TOL)
    _close(aux, jaux, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_pick_the_lowest_experts(arch):
    cfg, params, x = _setup(arch, seed=3)
    params["router"]["w"] = np.zeros_like(params["router"]["w"])
    t, k = x.shape[0] * x.shape[1], cfg.num_experts_per_tok
    tp = bridge.from_numpy_tree(params)
    _, gates, idx = moe.route(tp, cfg, _t(x.reshape(t, -1)))
    want = np.broadcast_to(np.arange(k), (t, k))
    np.testing.assert_array_equal(idx.numpy(), want)
    jscores = jax.nn.sigmoid(jnp.zeros((t, cfg.num_experts))) \
        if cfg.router_score == "sigmoid" else jnp.full((t, cfg.num_experts), 1 / cfg.num_experts)
    np.testing.assert_array_equal(np.asarray(jax.lax.top_k(jscores, k)[1]), want)
    np.testing.assert_allclose(gates.numpy(), np.full((t, k), 1 / k), rtol=0, atol=1e-7)
    jy, jaux = jmoe.moe_apply(params, cfg, x)
    y, aux = moe.moe_apply(tp, cfg, _t(x))
    _close(y, jy, TOL)
    _close(aux, jaux, TOL)


def test_top_k_keeps_the_lower_index_among_ties():
    scores = np.random.default_rng(4).integers(0, 3, (64, 16)).astype(np.float32)
    for k in (1, 2, 5):
        vals, idx = moe._top_k(_t(scores), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_moe_apply_matches_reference(arch):
    cfg, params, x = _setup(arch, seed=5, dtype="bfloat16")
    jy, jaux = jmoe.moe_apply(params, cfg, x)
    y, aux = moe.moe_apply(bridge.from_numpy_tree(params), cfg, _t(x))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(y, jy, BF16_TOL)
    _close(aux, jaux, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    cfg, params, x = _setup(arch, seed=6)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, cfg, xx)
        return jnp.sum(y) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, x)
    tp, tx = bridge.from_numpy_tree(params), _t(x).requires_grad_(True)
    leaves = [a.requires_grad_(True) for a in tree_leaves(tp)]
    y, aux = moe.moe_apply(tp, cfg, tx)
    grads = torch.autograd.grad(torch.sum(y) + aux, leaves + [tx])
    for (path, want), got in zip(tree_paths(_np(jgp)), grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg="/".join(path))
    _close(grads[-1], jgx, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_and_flops_match_reference(arch):
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        jcfg = j_get_config(arch, smoke=smoke)
        assert moe.moe_flops_per_token(cfg) == jmoe.moe_flops_per_token(jcfg)
        for t in (1, 4, 7, 512, 16_384):
            for cf in (0.5, 1.25, 8.0):
                assert moe._capacity(t, cfg.with_(capacity_factor=cf)) == \
                    jmoe._capacity(t, jcfg.with_(capacity_factor=cf))
    # decode at B 4 on Llama-4 full: one slot an expert, so a second token
    # routed to a busy expert is dropped (the reference's rule)
    assert moe._capacity(4, get_config("llama4-maverick-400b-a17b")) == 1
