"""The nlp transformer classifier (``models/nlp_small.py``, ``fl.tasks.nlp_task``)
against the JAX package's, on the same bridged parameters and tokens.

* configs: ``nlp-transformer`` full and smoke equal the reference's,
  field for field;
* logits, loss, gradients and MOON's pooled features on the reference's
  smoke parameters within 1e-5 (f32; the two differ by reassociation);
* the layer-group partition (keys and per-leaf ids) exactly;
* at full width, shapes only (no forward pass): 10,902,020 parameters in
  54 leaves, 85,312 packed rows at 8-row blocks, 6 groups, and the leaf
  order ``blocks < embed < head``;
* the model stays functional under ``torch.func.vmap``: per-client
  gradients of a stacked cohort equal one-client gradients.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.fl import nlp_task as j_nlp_task
from repro.kernels.masked_adam import ops as j_ops
from repro.models.layers import mlp_flops as j_mlp_flops
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import masking
from repro_torch.fl import nlp_task
from repro_torch.kernels.masked_adam import ops
from repro_torch.models.layers import mlp_flops
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    jadapter = j_nlp_task(num_classes=4, smoke=True)
    params = jax.tree.map(np.asarray, jadapter.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (6, 40)).astype(np.int32)
    labels = rng.integers(0, 4, (6,)).astype(np.int32)
    return {"jadapter": jadapter, "params": params, "tokens": tokens,
            "labels": labels, "adapter": nlp_task(num_classes=4, smoke=True),
            "tparams": bridge.from_numpy_tree(params)}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def test_configs_equal_the_reference():
    for smoke_ in (False, True):
        assert dataclasses.asdict(j_get_config("nlp-transformer", smoke=smoke_)) == \
            dataclasses.asdict(get_config("nlp-transformer", smoke=smoke_))
    for kind in ("gelu", "swiglu", "geglu"):
        assert mlp_flops(kind, 256, 1024) == j_mlp_flops(kind, 256, 1024)


def test_logits_loss_and_features_match_reference(smoke):
    from repro.models import nlp_small as j_nlp_small
    from repro_torch.models import nlp_small
    jcfg, cfg = j_get_config("nlp-transformer", smoke=True), get_config(
        "nlp-transformer", smoke=True)
    tok = torch.as_tensor(smoke["tokens"])
    _close(j_nlp_small.nlp_apply(smoke["params"], jcfg, smoke["tokens"]),
           nlp_small.nlp_apply(smoke["tparams"], cfg, tok))
    jloss = smoke["jadapter"].loss(smoke["params"], smoke["tokens"], smoke["labels"])
    loss, stats = smoke["adapter"].loss_and_stats(smoke["tparams"], tok,
                                                  torch.as_tensor(smoke["labels"]).long())
    assert stats is None
    _close(jloss, loss.item())
    _close(smoke["jadapter"].features(smoke["params"], smoke["tokens"]),
           smoke["adapter"].features(smoke["tparams"], tok))
    jacc = smoke["jadapter"].evaluate(smoke["params"], smoke["tokens"], smoke["labels"])
    acc = smoke["adapter"].evaluate(smoke["tparams"], tok, torch.as_tensor(smoke["labels"]))
    assert float(jacc) == float(acc)


def test_gradients_match_reference(smoke):
    jg = jax.grad(smoke["jadapter"].loss)(smoke["params"], smoke["tokens"],
                                          smoke["labels"])
    tok, lab = torch.as_tensor(smoke["tokens"]), torch.as_tensor(smoke["labels"]).long()
    g = torch.func.grad(lambda p: smoke["adapter"].loss_and_stats(p, tok, lab)[0])(
        smoke["tparams"])
    ja, tb = tree_paths(jax.tree.map(np.asarray, jg)), tree_paths(g)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        np.testing.assert_allclose(b.numpy(), a, rtol=TOL, atol=TOL, err_msg="/".join(path))


def test_partition_and_flops_match_reference(smoke):
    jpart = smoke["jadapter"].partition(smoke["params"])
    tpart = smoke["adapter"].partition(smoke["tparams"])
    assert tpart.group_keys == jpart.group_keys
    assert dict(tpart.assignment) == dict(jpart.assignment)
    assert tpart.group_keys == (("embed",), ("block", "blocks", 0),
                                ("block", "blocks", 1), ("head",))


def test_full_width_layout_matches_reference():
    """Shapes only: the reference's tree from ``jax.eval_shape``, the port's
    from its init."""
    jadapter = j_nlp_task(num_classes=4)
    jshapes = jax.eval_shape(jadapter.init, jax.random.key(0))
    adapter = nlp_task(num_classes=4)
    params = adapter.init(torch.Generator().manual_seed(0))
    paths = tree_paths(params)
    jpaths = tree_paths(jax.tree.map(lambda s: s, jshapes))
    assert [p for p, _ in paths] == [p for p, _ in jpaths]
    assert [tuple(t.shape) for _, t in paths] == [tuple(s.shape) for _, s in jpaths]
    assert len(paths) == 54
    assert sum(t.numel() for _, t in paths) == 10_902_020
    assert [p[0] for p, _ in paths] == sorted(p[0] for p, _ in paths)
    assert paths[0][0][0] == "blocks" and paths[-1][0][0] == "head"
    assert [p for p, _ in paths if p[0] == "embed"] == [("embed", "pos"), ("embed", "table")]
    assert ops.packed_rows(params, 8) == j_ops.packed_rows(jshapes, 8) == 85_312
    part = adapter.partition(params)
    assert part.num_groups == 6
    assert dict(part.assignment) == dict(jadapter.partition(jshapes).assignment)


def test_vmapped_gradients_equal_per_client(smoke):
    """Stacked params and tokens through ``torch.func.vmap``: each client's
    gradient equals its own, bit for bit (the embedding gather with a
    batched table and batched ids included)."""
    k = 3
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, 512, (k, 5, 24)).astype(np.int32))
    labs = torch.as_tensor(rng.integers(0, 4, (k, 5))).long()
    adapter, params = smoke["adapter"], smoke["tparams"]

    def f(p, x, y):
        return adapter.loss_and_stats(p, x, y)[0]

    stacked = masking.stack_trees([params] * k)
    g, loss = torch.func.vmap(torch.func.grad_and_value(f))(stacked, toks, labs)
    for c in range(k):
        gc, lc = torch.func.grad_and_value(f)(params, toks[c], labs[c])
        assert torch.equal(loss[c], lc)
        for (_, a), (_, b) in zip(tree_paths(g), tree_paths(gc)):
            assert torch.equal(a[c], b)
