"""The port's vmap engine against its sequential engine and against the JAX
package's ``VmapEngine``, end to end (FedAvg; ``test_torch_fl_vmap_fedprox.py``
and ``test_torch_fl_vmap_moon.py`` run the same comparison for the other two
algorithms, one file each to keep each file's JAX compile time short).

Mirrors ``tests/test_engine_equivalence.py``: ResNet-4, 3 ragged iid
clients of synthetic 8x8 images (36 / 56 / 40 samples: 2, 3 and 2 steps
per epoch at batch 16, one batch-width bucket, so padded steps are masked),
a mixed schedule (one FNU warm-up round, then partial group 0) and two FNU
rounds; a client below the batch size (12 / 36 / 20) routes through its own
bucket.  Fused (one cohort masked-Adam launch per bucket and step; on the
CPU its plain version) and unfused (plain Adam over stacked trees).  The
reference's initial parameters are bridged over numpy, and the host draws
(cohorts, seeds, batch plans) are the reference's, so all three runs train
on identical batches.

Tolerances, the ROADMAP regime: f32, ``adam_eps=1e-3`` (Adam's linear
regime), per-round loss and final params ≤1e-5 over these short schedules;
cost books and schedules exact; accuracy within one eval sample.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import FedPartSchedule, FNUSchedule
from repro.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                        make_vision_dataset)
from repro.fl import AlgoConfig, FLRunConfig, resnet_task, run_federated
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import schedule as tsched
from repro_torch.core.telemetry import StepSizeTracker
from repro_torch.data import pipeline as tpipe
from repro_torch.fl.batched import make_engine
from repro_torch.optim.adam import AdamConfig as TAdamConfig
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-5
BATCH = 16
MIXED = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                        cycles=1).rounds()[:2]
SCHEDULES = {"fedpart": MIXED, "fnu": FNUSchedule(2).rounds()}


def make_setup(sizes):
    spec = VisionDatasetSpec(num_classes=4, image_size=8)
    x, y = make_vision_dataset(spec, sum(sizes), seed=0)
    xe, ye = make_vision_dataset(spec, 64, seed=9)
    bounds = np.cumsum((0,) + tuple(sizes))
    parts = [np.arange(bounds[i], bounds[i + 1]) for i in range(len(sizes))]
    adapter = resnet_task("resnet4", num_classes=4)
    return {"adapter": adapter, "clients": build_clients(x, y, parts),
            "tclients": tpipe.build_clients(x, y, parts),
            "eval": balanced_eval_set(xe, ye, per_class=8),
            "init": jax.tree.map(np.asarray, adapter.init(jax.random.key(0))),
            "tadapter": tfl.resnet_task("resnet4", num_classes=4)}


@pytest.fixture(scope="module")
def setup():
    return make_setup((36, 56, 40))


@pytest.fixture(scope="module")
def small():
    return make_setup((12, 36, 20))


def _assert_runs_close(a_params, a_hist, b, tol):
    """``b`` (a port result) against params / history ``a``."""
    ja = tree_paths(jax.tree.map(np.asarray, a_params))
    tb = tree_paths(b.params)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, x), (_, y) in zip(ja, tb):
        np.testing.assert_allclose(y.detach().cpu().numpy(), x, rtol=tol, atol=tol,
                                   err_msg="/".join(path))
    assert [(h["round"], h["phase"], h["group"]) for h in b.history] == \
        [(h["round"], h["phase"], h["group"]) for h in a_hist]
    np.testing.assert_allclose([h["loss"] for h in b.history],
                               [h["loss"] for h in a_hist], rtol=tol, atol=tol)
    for x, y in zip(a_hist, b.history):
        assert abs(x["acc"] - y["acc"]) <= 1.0 / 64 + 1e-9


def check_engines(setup, algo, fused, rounds, tol=TOL, **kw):
    """Reference ``VmapEngine`` vs the port's vmap and sequential engines on
    ``rounds``: params, losses, accuracies, cost books."""
    common = dict(local_epochs=1, batch_size=BATCH, lr=2e-3, fused_adam=fused, **kw)
    common.setdefault("adam_eps", 1e-3)
    ref = run_federated(setup["adapter"], setup["clients"], setup["eval"], rounds,
                        FLRunConfig(algo=AlgoConfig(name=algo), engine="vmap", **common),
                        init_key=jax.random.key(0))
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
    out = {}
    for engine in ("vmap", "sequential"):
        cfg = tfl.FLRunConfig(algo=tfl.AlgoConfig(name=algo), engine=engine,
                              device="cpu", **common)
        out[engine] = tfl.run_federated(
            setup["tadapter"], setup["tclients"], setup["eval"], trounds, cfg,
            init_params=bridge.from_numpy_tree(setup["init"]))
    _assert_runs_close(ref.params, ref.history, out["vmap"], tol)
    seq = out["sequential"]
    _assert_runs_close(bridge.to_numpy_tree(seq.params), seq.history, out["vmap"], tol)
    for res in out.values():
        assert res.comm_total_bytes == ref.comm_total_bytes
        assert res.comm_fnu_bytes == ref.comm_fnu_bytes
        assert res.comp_total_flops == ref.comp_total_flops
        assert res.comp_fnu_flops == ref.comp_fnu_flops
    return out


@pytest.mark.parametrize("schedule", ["fedpart", "fnu"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fedavg_vmap_matches_sequential_and_reference(setup, fused, schedule):
    check_engines(setup, "fedavg", fused, SCHEDULES[schedule])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_small_client_bucket(small, fused):
    """A client below the batch size (12 < 16) trains at batch 12 in its own
    bucket; one partial round, as the reference's bucket test."""
    check_engines(small, "fedavg", fused, MIXED[1:])


def _engine(setup, name, **adam):
    params = bridge.from_numpy_tree(setup["init"])
    part = setup["tadapter"].partition(params)
    trainer = tfl.LocalTrainer(adapter=setup["tadapter"], partition=part,
                               algo=tfl.AlgoConfig(), adam=TAdamConfig(**adam))
    return params, make_engine(name, trainer=trainer, partition=part,
                               algo=tfl.AlgoConfig(), fused_adam=True)


def test_vmap_engine_guards(setup):
    params, engine = _engine(setup, "vmap")
    spec = tsched.RoundSpec(1, "partial", 0, 0)
    with pytest.raises(ValueError, match="positive"):
        engine.run_round(params, spec, setup["tclients"], seeds=[1, 2, 3],
                         weights=[0, 0, 0], epochs=1, batch_size=BATCH)
    with pytest.raises(ValueError, match="sequential"):
        engine.run_round(params, spec, setup["tclients"], seeds=[1, 2, 3],
                         weights=[1, 1, 1], epochs=1, batch_size=BATCH,
                         tracker=StepSizeTracker())
    # the async runtime's backend: cohort training without aggregation, one
    # slot per visible device (the one CPU device here)
    stacked, losses = engine.run_local(params, spec, setup["tclients"],
                                       seeds=[1, 2, 3], epochs=1, batch_size=BATCH)
    assert len(losses) == 3 and tree_leaves(stacked)[0].shape[0] == 3
    assert engine.cohort_pool(1, "cpu") is None
    assert engine.cohort_pool(2, "cpu").num_submeshes == 1
    with pytest.raises(ValueError, match="weight_decay"):
        _engine(setup, "vmap", weight_decay=0.1)
    # the shard_map engine (a one-rank mesh here) returns the vmap round
    shard = make_engine("shard_map", trainer=engine.trainer, partition=engine.partition,
                        algo=tfl.AlgoConfig(), fused_adam=True, device_type="cpu")
    got, got_losses, _ = shard.run_round(params, spec, setup["tclients"], seeds=[1, 2, 3],
                                         weights=[1, 1, 1], epochs=1, batch_size=BATCH)
    want, want_losses, _ = engine.run_round(params, spec, setup["tclients"],
                                            seeds=[1, 2, 3], weights=[1, 1, 1], epochs=1,
                                            batch_size=BATCH)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    # the round never writes the global params it was given
    before = [t.clone() for t in tree_leaves(params)]
    engine.run_round(params, spec, setup["tclients"], seeds=[1, 2, 3],
                     weights=[1, 1, 1], epochs=1, batch_size=BATCH)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
