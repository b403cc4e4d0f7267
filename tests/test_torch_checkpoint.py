"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint.io``: one file format both ways.

* a port checkpoint (``save_pytree`` / ``save_checkpoint``) loads in the
  reference with equal keys, dtypes, shapes and bytes — the same arrays
  the reference's own ``save_pytree`` gives for the same params — in f32
  (ResNet-8) and in bf16 (TinyLlama smoke, whose leaves numpy keeps as
  2-byte void words);
* a reference checkpoint loads in the port bit for bit, bf16 included;
* round state (the JSON sidecar) is equal across the two packages.

Tolerance: exact everywhere — only bytes are copied.
"""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config
from repro.fl.tasks import resnet_task
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.checkpoint import (load_checkpoint, load_pytree, load_round_state,
                                    save_checkpoint, save_pytree, save_round_state)
from repro_torch.tree import tree_paths


@pytest.fixture(scope="module", params=["resnet8-f32", "tinyllama-bf16"])
def ref_params(request):
    if request.param == "resnet8-f32":
        params = resnet_task("resnet8").init(jax.random.key(3))
    else:
        cfg = get_config("tinyllama-1.1b", smoke=True).with_(param_dtype="bfloat16")
        params = japi.init(jax.random.key(0), cfg)
    return jax.tree.map(np.asarray, params)


def _bytes_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_checkpoint_loads_in_the_reference(ref_params, tmp_path):
    tree = bridge.from_numpy_tree(ref_params)
    save_pytree(str(tmp_path / "port.npz"), tree)
    jio.save_pytree(str(tmp_path / "ref.npz"), ref_params)
    ported = jio.load_pytree(str(tmp_path / "port.npz"))
    own = jio.load_pytree(str(tmp_path / "ref.npz"))
    assert [p for p, _ in tree_paths(ported)] == [p for p, _ in tree_paths(ref_params)]
    for (path, a), (_, b), (_, r) in zip(tree_paths(ported), tree_paths(own),
                                         tree_paths(ref_params)):
        assert a.dtype == b.dtype and _bytes_equal(a, b), path
        assert _bytes_equal(a, r), path


def test_reference_checkpoint_loads_in_the_port(ref_params, tmp_path):
    jio.save_pytree(str(tmp_path / "ref.npz"), ref_params)
    tree = load_pytree(str(tmp_path / "ref"))           # suffix optional, as in the reference
    expect = bridge.from_numpy_tree(ref_params)
    assert [p for p, _ in tree_paths(tree)] == [p for p, _ in tree_paths(expect)]
    for (path, t), (_, e) in zip(tree_paths(tree), tree_paths(expect)):
        assert t.dtype == e.dtype and t.shape == e.shape, path
        assert torch.equal(t.view(torch.uint8) if t.dim() else t,
                           e.view(torch.uint8) if e.dim() else e), path


def test_port_round_trip_keeps_bf16_words(tmp_path):
    """No leaf is widened: a bf16 tree with NaN / inf / subnormal words and
    an int32 leaf comes back with its dtypes and words unchanged."""
    words = torch.tensor([0x7FC1, 0x7F80, 0xFF80, 0x0001, 0x8000, 0x3F80],
                         dtype=torch.int32).to(torch.int16)
    tree = {"a": {"w": words.view(torch.bfloat16).reshape(2, 3)},
            "b": torch.arange(5, dtype=torch.int32),
            "c": torch.linspace(-1, 1, 7, dtype=torch.float32)}
    save_pytree(str(tmp_path / "t.npz"), tree)
    back = load_pytree(str(tmp_path / "t.npz"))
    for (path, a), (_, b) in zip(tree_paths(tree), tree_paths(back)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), path


def test_round_state_is_equal_across_packages(tmp_path):
    state = {"rounds": 11, "best_acc": 0.4375, "schedule": [1, 2, 3], "seed": 0}
    save_checkpoint(str(tmp_path / "port"), {"w": torch.arange(6.0).reshape(2, 3)},
                    state)
    params, ref_state = jio.load_checkpoint(str(tmp_path / "port"))
    assert ref_state == state
    np.testing.assert_array_equal(params["w"], np.arange(6.0).reshape(2, 3))

    jio.save_checkpoint(str(tmp_path / "ref"), {"w": np.arange(6.0).reshape(2, 3)},
                        state)
    tparams, port_state = load_checkpoint(str(tmp_path / "ref"))
    assert port_state == state
    assert torch.equal(tparams["w"], torch.arange(6.0, dtype=torch.float64).reshape(2, 3))

    save_round_state(str(tmp_path / "s" / "state.json"), state)
    assert jio.load_round_state(str(tmp_path / "s" / "state.json")) == \
        load_round_state(str(tmp_path / "s" / "state.json")) == state
