"""bf16 training held against the reference: the loss and the gradients of
the whole tree of ``tinyllama-1.1b`` and ``zamba2-7b`` at smoke size with
bf16 parameters and activations, in both packages, each measured against
the f32 run on the same values.

The parameters are the reference's ``api.init`` at bf16, bridged to the
port as they are; the f32 run takes the same values upcast, in the
reference's f32 config.  One numpy batch of 4 x 32 tokens.  A leaf's error
is its max-abs gradient difference from the f32 run, relative to the f32
gradient's max-abs.

Run as a script, it prints those errors and losses:

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/test_torch_steps_bf16.py

Bounds: the port's largest leaf error is at most ``MULTIPLE`` (2) times
the reference's own largest (measured: TinyLlama 0.021 against the
reference's 0.021, Zamba2 0.078 against 0.102; the worst single leaf is
Zamba2's ``tail/mamba/a_log``, 0.078 against 0.040); each bf16 loss is
within ``LOSS_TOL`` (2e-3) of the f32 loss (measured ≤1.4e-3).  bf16 keeps
8 bits of mantissa, so the two packages' bf16 roundings differ from the
f32 run by the same order but not the same values; the bound says the
port's bf16 arithmetic is no worse than the reference's by more than the
stated multiple.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

MULTIPLE = 2.0
LOSS_TOL = 2e-3
BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")


def measure(arch: str) -> dict:
    """``{"f32": (loss, grads), "ref": ..., "port": ...}`` with every
    gradient as an f32 numpy array, in the reference's leaf order."""
    jcfg = j_get_config(arch, smoke=True)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0), jcfg.with_(**BF16)))
    upcast = jax.tree.map(
        lambda x: x.astype(np.float32) if x.dtype == jnp.bfloat16 else x, jparams)
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}

    def ref(cfg, params):
        loss, grads = jax.value_and_grad(
            lambda p: japi.loss(p, cfg, batch, remat=False))(params)
        return float(loss), [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)]

    params = bridge.from_numpy_tree(jparams)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = api.loss(params, get_config(arch, smoke=True).with_(**BF16),
                    bridge.from_numpy_tree(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == x.dtype for g, x in zip(grads, leaves))
    return {"arch": arch,
            "paths": ["/".join(p) for p, _ in tree_paths(params)],
            "f32": ref(jcfg, upcast), "ref": ref(jcfg.with_(**BF16), jparams),
            "port": (float(loss.detach()), [g.float().numpy() for g in grads])}


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "zamba2-7b"])
def runs(request):
    return measure(request.param)


def _leaf_errors(grads, truth):
    return np.asarray([np.abs(g - t).max() / np.abs(t).max() for g, t in zip(grads, truth)])


def test_bf16_grads_within_a_multiple_of_the_reference_error(runs):
    truth = runs["f32"][1]
    ref_err = _leaf_errors(runs["ref"][1], truth)
    port_err = _leaf_errors(runs["port"][1], truth)
    assert len(port_err) == len(ref_err) == len(runs["paths"])
    worst = int(np.argmax(port_err))
    assert port_err.max() <= MULTIPLE * ref_err.max(), (
        f"{runs['arch']}: {runs['paths'][worst]} {port_err[worst]:.4g} against the "
        f"reference's largest {ref_err.max():.4g}")
    assert np.isfinite(port_err).all()


def test_bf16_losses_near_f32(runs):
    f32 = runs["f32"][0]
    assert abs(runs["ref"][0] - f32) <= LOSS_TOL
    assert abs(runs["port"][0] - f32) <= LOSS_TOL


if __name__ == "__main__":
    for arch in ("tinyllama-1.1b", "zamba2-7b"):
        r = measure(arch)
        ref_err = _leaf_errors(r["ref"][1], r["f32"][1])
        port_err = _leaf_errors(r["port"][1], r["f32"][1])
        worst = int(np.argmax(port_err / ref_err))
        print(f"{arch}: largest leaf error port {port_err.max():.4g}, reference "
              f"{ref_err.max():.4g}; worst leaf ratio {r['paths'][worst]} "
              f"{port_err[worst]:.4g} / {ref_err[worst]:.4g}; loss f32 "
              f"{r['f32'][0]:.6f}, reference bf16 {r['ref'][0]:.6f}, port bf16 "
              f"{r['port'][0]:.6f}")
