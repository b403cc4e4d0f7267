"""The port's ResNet (``repro_torch.models.resnet``, ``fl.tasks.resnet_task``)
against the reference on bridged parameters and the same numpy images.

Covers the traps the port has to get right: XLA's ``padding="SAME"`` with
stride 2 pads (0, 1) on even inputs; BatchNorm normalises with the biased
variance and moves its running moments as ``0.9·old + 0.1·batch``; blocks
run in sorted order with the stride derived from ``sc_conv``.

Tolerances: logits, features and BN-stat updates ≤1e-5 (f32 convolutions
summed in another order by XLA and oneDNN); gradients ≤1e-4 relative to
each leaf's largest entry (backward sums reorder further).
"""

import jax
import numpy as np
import pytest
import torch

from repro.fl import tasks as jtasks
from repro.models import resnet as jresnet
from repro_torch import bridge
from repro_torch.fl import tasks as ttasks
from repro_torch.models import resnet as tresnet
from repro_torch.optim.partial import value_and_grad
from repro_torch.tree import tree_paths

# One torch thread per test process (see test_torch_masked_adam.py).
torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", params=["resnet4", "resnet8"])
def case(request):
    depth = request.param
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 20, 8).astype(np.int32)
    ja = jtasks.resnet_task(depth, num_classes=20)
    params = ja.init(jax.random.key(2))
    # non-trivial BN running moments, so eval mode is exercised for real
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jax.numpy.abs(jax.random.normal(
            jax.random.key(len(str(p))), a.shape)) if "ema" in str(p) else a, params)
    np_params = jax.tree.map(np.asarray, params)
    return depth, ja, params, bridge.from_numpy_tree(np_params), x, y


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("train", [True, False])
def test_logits_and_bn_stats(case, train):
    _, _, params, tparams, x, _ = case
    jl, jstats = jax.jit(jresnet.resnet_apply, static_argnums=2)(params, x, train)
    with torch.no_grad():
        tl, tstats = tresnet.resnet_apply(tparams, torch.tensor(x), train=train)
    _close(jl, tl, FWD_TOL, "logits")
    js = tree_paths(jax.tree.map(np.asarray, jstats))
    ts = tree_paths(tstats)
    assert [p for p, _ in js] == [p for p, _ in ts]
    for (path, a), (_, b) in zip(js, ts):
        _close(a, b, FWD_TOL, "/".join(path))


def test_features_and_accuracy(case):
    depth, ja, params, tparams, x, y = case
    ta = ttasks.resnet_task(depth, num_classes=20)
    with torch.no_grad():
        _close(jax.jit(jtasks._resnet_features)(params, x),
               ta.features(tparams, torch.tensor(x)), FWD_TOL, "features")
    assert float(ja.evaluate(params, x, y)) == \
        float(ta.evaluate(tparams, torch.tensor(x), torch.tensor(y)))


def test_loss_and_grads(case):
    depth, ja, params, tparams, x, y = case
    ta = ttasks.resnet_task(depth, num_classes=20)
    jloss, jgrads = jax.jit(jax.value_and_grad(ja.loss))(params, x, y)
    tloss, tgrads = value_and_grad(
        lambda p: ta.loss_and_stats(p, torch.tensor(x), torch.tensor(y))[0], tparams)
    _close(jloss, tloss, FWD_TOL, "loss")
    jg = tree_paths(jax.tree.map(np.asarray, jgrads))
    tg = tree_paths(tgrads)
    assert [p for p, _ in jg] == [p for p, _ in tg]
    for (path, a), (_, b) in zip(jg, tg):
        scale = max(float(np.abs(a).max()), 1e-12)
        err = float(np.abs(b.numpy() - a).max())
        assert err <= GRAD_TOL * scale, ("/".join(path), err, scale)


@pytest.mark.parametrize("hw", [9, 15])
def test_same_padding_on_odd_inputs(hw):
    """Odd spatial sizes pad symmetrically under stride 2; the shortcut and
    the strided 3x3 conv must still land on XLA's output grid."""
    params = jtasks.resnet_task("resnet4", num_classes=4).init(jax.random.key(5))
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(np.float32)
    jl, _ = jresnet.resnet_apply(params, x, train=True)
    with torch.no_grad():
        tl, _ = tresnet.resnet_apply(
            bridge.from_numpy_tree(jax.tree.map(np.asarray, params)),
            torch.tensor(x), train=True)
    _close(jl, tl, FWD_TOL, "logits")


def test_torch_init_matches_reference_structure():
    """Without bridged weights the port draws the reference's distributions
    (He-normal convs, 0.01·N head, BN ones / zeros) from a torch.Generator."""
    ref = jax.tree.map(np.asarray, jtasks.resnet_task("resnet8").init(jax.random.key(0)))
    port = ttasks.resnet_task("resnet8").init(torch.Generator().manual_seed(0))
    rp, pp = tree_paths(ref), tree_paths(port)
    assert [p for p, _ in rp] == [p for p, _ in pp]
    for (path, a), (_, b) in zip(rp, pp):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        name = path[-1]
        if name in ("scale", "var_ema"):
            assert torch.equal(b, torch.ones_like(b))
        elif name in ("bias", "mean_ema", "b"):
            assert torch.equal(b, torch.zeros_like(b))
        elif b.numel() >= 4096:
            fan_in = a.shape[0] * a.shape[1] * a.shape[2] if a.ndim == 4 else None
            want = np.sqrt(2.0 / fan_in) if fan_in else 0.01
            assert abs(float(b.std()) / want - 1.0) < 0.1, path
