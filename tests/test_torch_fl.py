"""The port's FL loop against the JAX package's, end to end.

Same federation on both sides: ResNet-4 (the reference's test-scale spec),
3 ragged iid clients of synthetic 8x8 images, the reference's initial
parameters bridged over numpy, FedPart (one warm-up round, then each of the
6 groups once) and its matched FNU baseline.  The host-side draws (cohorts,
per-(round, client) seeds, batch plans) are the reference's, so both sides
train on identical batches.

Tolerances: per-round loss and final parameters ≤1e-4 at ``adam_eps=1e-3``
— Adam's bias-corrected early steps amplify f32 reassociation noise near
zero gradients, and 1e-3 keeps the comparison in its linear regime (the
reference's engine-equivalence tests pin their cross-form checks the same
way).
Cost books are integer / host arithmetic: exact.  Eval accuracy may differ
by at most one eval sample (a logit tie broken by rounding).

``test_torch_fl_fedprox.py`` and ``test_torch_fl_moon.py`` run the same
comparison for FedProx and MOON (one file each keeps every file's JAX
compile time short).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import FedPartSchedule, matched_fnu
from repro.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                        make_vision_dataset)
from repro.fl import AlgoConfig, FLRunConfig, LocalTrainer, resnet_task, run_federated
from repro.optim.adam import AdamConfig
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import schedule as tsched
from repro_torch.data import pipeline as tpipe
from repro_torch.fl.population import ClientPopulation
from repro_torch.optim.adam import AdamConfig as TAdamConfig
from repro_torch.tree import tree_paths

# One torch thread per test process (see test_torch_masked_adam.py).
torch.set_num_threads(1)

TOL = 1e-4
SIZES = (36, 56, 40)      # 2, 3 and 2 steps per epoch at batch 16
BATCH = 16
SCHEDULES = {
    "fedpart": FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                               cycles=1),
}
SCHEDULES["fnu"] = matched_fnu(SCHEDULES["fedpart"])


@pytest.fixture(scope="module")
def setup():
    spec = VisionDatasetSpec(num_classes=4, image_size=8)
    x, y = make_vision_dataset(spec, sum(SIZES), seed=0)
    xe, ye = make_vision_dataset(spec, 64, seed=9)
    eval_set = balanced_eval_set(xe, ye, per_class=8)
    bounds = np.cumsum((0,) + SIZES)
    parts = [np.arange(bounds[i], bounds[i + 1]) for i in range(len(SIZES))]
    adapter = resnet_task("resnet4", num_classes=4)
    init = jax.tree.map(np.asarray, adapter.init(jax.random.key(0)))
    return {"adapter": adapter, "clients": build_clients(x, y, parts),
            "tclients": tpipe.build_clients(x, y, parts), "eval": eval_set,
            "init": init, "tadapter": tfl.resnet_task("resnet4", num_classes=4)}


def _configs(algo, fused):
    kw = dict(local_epochs=1, batch_size=BATCH, lr=2e-3, adam_eps=1e-3,
              fused_adam=fused)
    return (FLRunConfig(algo=AlgoConfig(name=algo), **kw),
            tfl.FLRunConfig(algo=tfl.AlgoConfig(name=algo), device="cpu", **kw))


def _assert_trees_close(jtree, ttree, tol):
    ja = tree_paths(jax.tree.map(np.asarray, jtree))
    tb = tree_paths(ttree)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        np.testing.assert_allclose(b.detach().cpu().numpy(), a, rtol=tol, atol=tol,
                                   err_msg="/".join(path))


def check_run_matches_reference(setup, algo, fused, schedule):
    """Run ``schedule`` through both packages and hold the port to the
    reference: losses, final params, accuracies and cost books."""
    rounds = SCHEDULES[schedule].rounds()
    jcfg, tcfg = _configs(algo, fused)
    ref = run_federated(setup["adapter"], setup["clients"], setup["eval"], rounds,
                        jcfg, init_key=jax.random.key(0))
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
    out = tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                            trounds, tcfg,
                            init_params=bridge.from_numpy_tree(setup["init"]))
    assert [(h["round"], h["phase"], h["group"]) for h in out.history] == \
        [(h["round"], h["phase"], h["group"]) for h in ref.history]
    np.testing.assert_allclose([h["loss"] for h in out.history],
                               [h["loss"] for h in ref.history], rtol=TOL, atol=TOL)
    n_eval = min(jcfg.eval_batch, len(setup["eval"][1]))
    for a, b in zip(ref.history, out.history):
        assert abs(a["acc"] - b["acc"]) <= 1.0 / n_eval + 1e-9
    _assert_trees_close(ref.params, out.params, TOL)
    assert out.comm_total_bytes == ref.comm_total_bytes
    assert out.comm_fnu_bytes == ref.comm_fnu_bytes
    assert out.comp_total_flops == ref.comp_total_flops
    assert out.comp_fnu_flops == ref.comp_fnu_flops
    assert dict(out.partition.assignment) == dict(ref.partition.assignment)


@pytest.mark.parametrize("schedule", ["fedpart", "fnu"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fedavg_run_matches_reference(setup, fused, schedule):
    check_run_matches_reference(setup, "fedavg", fused, schedule)


@pytest.mark.parametrize("group", [-1, 3])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_local_round_matches_reference(setup, fused, group):
    """One client's local round (3 steps): FNU and a partial group."""
    part = setup["adapter"].partition(setup["init"])
    trainer = LocalTrainer(adapter=setup["adapter"], partition=part,
                           algo=AlgoConfig(), adam=AdamConfig(lr=2e-3, eps=1e-3))
    params, loss = trainer.run_local_round(
        setup["init"], group, setup["clients"][1], epochs=1, batch_size=BATCH,
        seed=11, fused=fused)
    tparams0 = bridge.from_numpy_tree(setup["init"])
    ttrainer = tfl.LocalTrainer(
        adapter=setup["tadapter"], partition=setup["tadapter"].partition(tparams0),
        algo=tfl.AlgoConfig(), adam=TAdamConfig(lr=2e-3, eps=1e-3))
    tparams, tloss = ttrainer.run_local_round(
        tparams0, group, setup["tclients"][1], epochs=1, batch_size=BATCH, seed=11,
        fused=fused)
    assert abs(tloss - loss) <= TOL
    _assert_trees_close(params, tparams, TOL)
    # the global tree the round started from is never written
    for (_, a), (_, b) in zip(tree_paths(tparams0), tree_paths(setup["init"])):
        assert np.array_equal(a.numpy(), b)


def test_unported_options_raise(setup, tmp_path):
    """Every option of the reference runs: the shard_map engine (ROADMAP
    item 13, here a one-rank mesh) returns the vmap engine's result within
    1e-5; the async runtime and a streamed population (items 12 and 11),
    compression and a bounded, spilling state store run too."""
    base = dict(device="cpu", local_epochs=1, batch_size=BATCH)
    assert tfl.FLRunConfig(**base, runtime="async").runtime == "async"
    rounds = tsched.FedPartSchedule(num_groups=6, warmup_rounds=1).rounds()[:2]
    init = bridge.from_numpy_tree(setup["init"])

    def run(clients=setup["tclients"], **kw):
        return tfl.run_federated(setup["tadapter"], clients, setup["eval"], rounds,
                                 tfl.FLRunConfig(**base, **kw), init_params=init)

    class Streamed(ClientPopulation):
        num_clients = 3

        def dataset(self, client_id):
            return setup["tclients"][client_id]

    shard, vmap = run(engine="shard_map"), run(engine="vmap")
    for (path, a), (_, b) in zip(tree_paths(shard.params), tree_paths(vmap.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg="/".join(path))
    np.testing.assert_allclose([h["loss"] for h in shard.history],
                               [h["loss"] for h in vmap.history], rtol=1e-5, atol=1e-5)
    assert shard.comm_total_bytes == vmap.comm_total_bytes
    streamed, listed = run(clients=Streamed()), run()
    assert [h["loss"] for h in streamed.history] == [h["loss"] for h in listed.history]
    for kw in (dict(compression="int8"), dict(state_store_entries=2),
               dict(state_store_entries=1, state_store_spill=str(tmp_path)),
               dict(algo=tfl.AlgoConfig(name="moon"), compression="topk",
                    state_store_entries=1, state_store_spill=str(tmp_path)),
               dict(runtime="async")):
        res = run(**kw)
        assert all(np.isfinite(h["loss"]) for h in res.history)
    # a plan kind that collapses to the homogeneous one is the default path
    a = run(plan="nested", capacity_tiers=(1.0,))
    b = run()
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tfl.FLRunConfig()
    with pytest.raises(RuntimeError):
        tfl.FLRunConfig(device="cuda:0")
    with pytest.raises(ValueError):
        tfl.FLRunConfig(device="mps")
