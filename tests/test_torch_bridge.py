"""The PyTorch port's weight bridge and its isolation from JAX.

* ``repro_torch.bridge`` carries the reference's parameters into the port
  and back bit-exactly (ResNet-4 / ResNet-8 in f32, TinyLlama smoke in
  bf16, which numpy only knows as ``ml_dtypes.bfloat16``, Zamba2 smoke in
  bf16 with its f32 ``a_log`` / ``dt_bias`` and two-level stacks), and
  ``load_npz`` reads a ``checkpoint.io.save_pytree`` file without JAX;
* the port flattens trees in ``jax.tree.flatten``'s (sorted-key) order,
  which the masked-Adam pack layout and every block mask depend on;
* importing every module of ``repro_torch`` (the serving and async-runtime
  modules named) and ``chip_smoke.py`` pulls in neither ``jax`` nor
  ``repro``.

Tolerance: exact everywhere — the bridge only copies bytes.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.checkpoint.io import save_pytree
from repro.configs import get_config
from repro.fl.tasks import resnet_task
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.tree import tree_paths

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(scope="module", params=["resnet4", "resnet8"])
def ref_params(request):
    params = resnet_task(request.param).init(jax.random.key(3))
    return jax.tree.map(np.asarray, params)


def test_round_trip_is_bit_exact(ref_params):
    tree = bridge.from_numpy_tree(ref_params, "cpu")
    back = bridge.to_numpy_tree(tree)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    back_flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ref_flat] == [p for p, _ in back_flat]
    for (_, a), (_, b) in zip(ref_flat, back_flat):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bf16_round_trip_is_bit_exact():
    """bf16 leaves cross as their 16-bit words: ``torch.bfloat16`` in the
    port, ``ml_dtypes.bfloat16`` back, no value rounded either way."""
    import torch
    cfg = get_config("tinyllama-1.1b", smoke=True).with_(param_dtype="bfloat16")
    ref = jax.tree.map(np.asarray, japi.init(jax.random.key(0), cfg))
    tree = bridge.from_numpy_tree(ref, "cpu")
    back = bridge.to_numpy_tree(tree)
    ref_flat, back_flat = tree_paths(ref), tree_paths(back)
    assert [p for p, _ in ref_flat] == [p for p, _ in back_flat]
    for (path, a), (_, t), (_, b) in zip(ref_flat, tree_paths(tree), back_flat):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16, path
        assert b.dtype == a.dtype and b.shape == a.shape, path
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16)), path
        assert np.array_equal(a.astype(np.float32), t.float().numpy()), path


def test_mixed_dtype_stacked_round_trip_is_bit_exact():
    """zamba2-7b smoke in bf16: bf16 leaves beside the f32 ``a_log`` and
    ``dt_bias``, Mamba2 leaves stacked on two axes (chunks, blocks per
    chunk); every leaf crosses with its own dtype, bit for bit."""
    import torch
    cfg = get_config("zamba2-7b", smoke=True).with_(param_dtype="bfloat16",
                                                     activation_dtype="bfloat16")
    ref = jax.tree.map(np.asarray, japi.init(jax.random.key(0), cfg))
    tree = bridge.from_numpy_tree(ref, "cpu")
    back = bridge.to_numpy_tree(tree)
    ref_flat, back_flat = tree_paths(ref), tree_paths(back)
    assert [p for p, _ in ref_flat] == [p for p, _ in back_flat]
    dtypes = set()
    for (path, a), (_, t), (_, b) in zip(ref_flat, tree_paths(tree), back_flat):
        assert b.dtype == a.dtype and b.shape == a.shape == tuple(t.shape), path
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[a.dtype.name], path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
        dtypes.add((path[-1], a.dtype.name))
    assert {("a_log", "float32"), ("dt_bias", "float32"),
            ("conv_w", "bfloat16")} <= dtypes
    assert tree["chunks"]["mamba"]["a_log"].shape == (2, 2, 8)


def test_flatten_order_matches_jax(ref_params):
    tree = bridge.from_numpy_tree(ref_params)
    jax_paths = [tuple(str(k.key) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    port = tree_paths(tree)
    assert [p for p, _ in port] == jax_paths
    for (_, t), leaf in zip(port, jax.tree.leaves(ref_params)):
        assert np.array_equal(t.numpy(), leaf)


def test_load_npz_reads_save_pytree(ref_params, tmp_path):
    path = str(tmp_path / "params.npz")
    save_pytree(path, ref_params)
    loaded = bridge.load_npz(path)
    assert [p for p, _ in tree_paths(loaded)] == \
        [p for p, _ in tree_paths(ref_params)]
    for (_, a), (_, b) in zip(tree_paths(loaded), tree_paths(ref_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the path without the suffix is accepted, as by checkpoint.io.load_pytree
    assert tree_paths(bridge.load_npz(path[:-4]))[0][0] == tree_paths(loaded)[0][0]


def test_port_and_chip_smoke_import_no_jax():
    """A fresh interpreter imports every ``repro_torch`` module and the
    modules ``chip_smoke.py`` imports; neither ``jax`` nor ``repro`` may be
    loaded afterwards."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        sys.path.insert(0, {ROOT!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        serving = ["repro_torch.configs.base", "repro_torch.configs.tinyllama_1_1b",
                   "repro_torch.configs.zamba2_7b",
                   "repro_torch.models.layers", "repro_torch.models.attention",
                   "repro_torch.models.ssm",
                   "repro_torch.models.transformer", "repro_torch.models.api",
                   "repro_torch.kernels.flash_attention.ref",
                   "repro_torch.kernels.flash_attention.kernel",
                   "repro_torch.kernels.flash_attention.ops",
                   "repro_torch.kernels.ssd_chunk.ref",
                   "repro_torch.kernels.ssd_chunk.kernel",
                   "repro_torch.kernels.ssd_chunk.ops",
                   "repro_torch.launch.steps", "repro_torch.launch.serve"]
        runtime = ["repro_torch.fl.population.synthetic",
                   "repro_torch.fl.runtime.clients", "repro_torch.fl.runtime.policy",
                   "repro_torch.fl.runtime.control", "repro_torch.fl.runtime.engine",
                   "repro_torch.core.telemetry", "repro_torch.launch.mesh"]
        missing = sorted(set(serving + runtime) - set(names))
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad, missing)
        sys.exit(1 if bad or missing or len(names) < 67 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stdout + out.stderr
