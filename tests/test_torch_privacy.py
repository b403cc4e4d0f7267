"""The port's DLG attack and metrics (``repro_torch.fl.privacy``) against
``repro.fl.privacy``, and the port's SGD (``repro_torch.optim.sgd``)
against ``repro.optim.sgd``.

* the attack objective (the gradient-match loss of a candidate input) and
  its gradient with respect to the candidate — a double backward — at the
  same numpy candidate, on ResNet-8 at 16×16 as
  ``benchmarks/table9_privacy.py`` sets it up, for the full observation
  and for one group's (``masking.select``), against the reference's
  ``_grad_of_sample`` / ``_grad_match_loss``; an ``observe_transform``
  applies to the target's observation only;
* ``mse`` / ``psnr`` against the reference's;
* in the port, the attack reconstructs worse from one group's gradients
  than from the full gradients (``tests/test_privacy.py``'s claim, on its
  small model bridged over);
* ``sgd_update`` with and without momentum against the reference's, f32
  and bf16 params.

Tolerances: objective and gradient ≤1e-5 relative to the objective's scale
(f32 sums over ~10⁵ gradient entries in another order), metrics ≤1e-6,
SGD exact (the same ops, f32 math, one rounding to the param dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masking as jmasking
from repro.core.partition import build_partition as j_build_partition
from repro.fl import privacy as jprivacy
from repro.models import resnet as jresnet
from repro.optim import sgd as jsgd
from repro_torch import bridge
from repro_torch.core.partition import build_partition
from repro_torch.fl import privacy
from repro_torch.models import resnet
from repro_torch.optim import sgd
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-5


@pytest.fixture(scope="module")
def resnet8():
    """Table 9's setting: ResNet-8 with 8 classes, one 16×16 target, label 1."""
    jparams = jax.tree.map(np.asarray,
                           jresnet.resnet_init(jax.random.key(0), jresnet.RESNET8, 8))
    target = np.array(jax.random.normal(jax.random.key(5), (1, 16, 16, 3)) * 0.5)
    x_hat = (np.random.default_rng(11).standard_normal((1, 16, 16, 3)) * 0.5
             ).astype(np.float32)
    return jparams, target, x_hat


def _j_loss(p, x):
    logits, _ = jresnet.resnet_apply(p, x, train=False)
    return jresnet.cls_loss(logits, jnp.array([1]))


def _t_loss(p, x):
    logits, _ = resnet.resnet_apply(p, x, train=False)
    return resnet.cls_loss(logits, torch.tensor([1]))


def _qdq(g):
    return jax.tree.map(lambda a: jnp.round(a * 64.0) / 64.0, g)


def _t_qdq(g):
    return {k: _t_qdq(v) for k, v in g.items()} if isinstance(g, dict) \
        else torch.round(g * 64.0) / 64.0


@pytest.mark.parametrize("group,transform", [(None, False), (0, False), (9, False),
                                             (None, True)])
def test_attack_objective_and_gradient_match_reference(resnet8, group, transform):
    jparams, target, x_hat = resnet8
    jpart = j_build_partition(jparams, jresnet.resnet_group_key, jresnet.resnet_order_key)

    def observed(x):
        g = jprivacy._grad_of_sample(_j_loss, jparams, x)
        return g if group is None else jmasking.select(g, jpart, group)

    target_g = observed(target)
    if transform:
        target_g = _qdq(target_g)
    target_g = jax.lax.stop_gradient(target_g)
    jval, jgrad = jax.value_and_grad(
        lambda x: jprivacy._grad_match_loss(observed(x), target_g))(x_hat)

    params = bridge.from_numpy_tree(jparams)
    part = build_partition(params, resnet.resnet_group_key, resnet.resnet_order_key)
    objective = privacy.attack_objective(
        _t_loss, params, torch.from_numpy(target),
        partition=part if group is not None else None, group=group,
        observe_transform=_t_qdq if transform else None)
    x = torch.from_numpy(x_hat).requires_grad_(True)
    val = objective(x)
    (grad,) = torch.autograd.grad(val, x)
    scale = max(1.0, abs(float(jval)))
    assert abs(float(val.detach()) - float(jval)) <= TOL * scale
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=TOL * max(1.0, float(np.abs(jgrad).max())))


def test_group_observation_needs_its_partition(resnet8):
    jparams, target, _ = resnet8
    with pytest.raises(ValueError, match="partition"):
        privacy.attack_objective(_t_loss, bridge.from_numpy_tree(jparams),
                                 torch.from_numpy(target), group=0)


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    for noise in (0.0, 1e-4, 0.1, 2.0):
        y = (x + noise * rng.standard_normal(x.shape)).astype(np.float32)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        assert abs(float(privacy.mse(tx, ty)) - float(jprivacy.mse(x, y))) <= 1e-6
        for dr in (1.0, 2.0):
            assert abs(float(privacy.psnr(tx, ty, dr)) -
                       float(jprivacy.psnr(x, y, dr))) <= 1e-6 * max(
                           1.0, abs(float(jprivacy.psnr(x, y, dr))))


def _tiny_model():
    """``tests/test_privacy.py``'s model, its params bridged over."""
    ks = jax.random.split(jax.random.key(0), 3)
    jparams = {
        "layer1": {"w": jax.random.normal(ks[0], (48, 24)) * 0.2},
        "layer2": {"w": jax.random.normal(ks[1], (24, 16)) * 0.2},
        "head": {"w": jax.random.normal(ks[2], (16, 4)) * 0.2},
    }
    params = bridge.from_numpy_tree(jax.tree.map(np.asarray, jparams))

    def loss_fn(p, x):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ p["layer1"]["w"])
        h = torch.tanh(h @ p["layer2"]["w"])
        logits = h @ p["head"]["w"]
        return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])

    target = torch.from_numpy(np.array(jax.random.normal(jax.random.key(5), (1, 48))
                                       * 0.5))
    return params, loss_fn, target


def test_partial_observation_reconstructs_worse():
    params, loss_fn, target = _tiny_model()
    part = build_partition(params)
    cfg = privacy.DLGConfig(iterations=120, lr=0.05)
    x_full, m_full = privacy.dlg_attack(loss_fn, params, target, cfg)
    x_part, m_part = privacy.dlg_attack(loss_fn, params, target, cfg,
                                        partition=part, group=2)   # head grads only
    assert np.isfinite(float(m_full)) and np.isfinite(float(m_part))
    mse_full, mse_part = float(privacy.mse(target, x_full)), float(privacy.mse(target, x_part))
    assert mse_part > 1.2 * mse_full, (mse_full, mse_part)
    assert float(privacy.psnr(target, x_part, 2.0)) < float(privacy.psnr(target, x_full, 2.0))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_matches_reference(momentum, dtype):
    rng = np.random.default_rng(1)
    jp = {"a": {"w": jnp.asarray(rng.standard_normal((6, 5)), dtype)},
          "b": jnp.asarray(rng.standard_normal(7), dtype)}
    cfg, jcfg = sgd.SGDConfig(lr=0.05, momentum=momentum), jsgd.SGDConfig(0.05, momentum)
    p = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp))
    state, jstate = sgd.sgd_init(p), jsgd.sgd_init(jp)
    for _ in range(3):
        jg = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jp)
        g = bridge.from_numpy_tree(jax.tree.map(np.asarray, jg))
        jp, jstate = jsgd.sgd_update(jg, jstate, jp, jcfg)
        p, state = sgd.sgd_update(g, state, p, cfg)
    atol = 0.0
    for (path, a), (_, b) in zip(tree_paths(jax.tree.map(np.asarray, jp)),
                                 tree_paths(p)):
        assert b.dtype == getattr(torch, dtype), path
        np.testing.assert_allclose(b.float().numpy(), a.astype(np.float32), rtol=atol,
                                   atol=atol, err_msg="/".join(path))
    for (path, a), (_, b) in zip(tree_paths(jax.tree.map(np.asarray, jstate.velocity)),
                                 tree_paths(state.velocity)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg="/".join(path))
