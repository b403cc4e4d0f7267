"""The port's shard_map engine at world size 1 on per-client layer plans and
compressed uploads, against the JAX package's ``ShardMapEngine`` and
sequential engine; and the client mesh's helpers against
``repro.launch.mesh``.

Setup as ``tests/test_torch_fl_shard.py``.  The nested plan is
``tests/test_engine_equivalence.py``'s (capacity tiers 0.34 / 0.67 / 1.0,
an FNU warm-up round and a partial round on group 4 that tier 0 clamps):
the engine reduces each group over its own trainers (fused: one einsum over
the packed plan rows), and a group nobody trained keeps the global bit
for bit.  int8 and top-k compression with error feedback run over two
rounds, so the second round's uploads carry the first round's residuals.

Tolerances: plans at the reference's plan regime (``adam_eps=1e-2``),
everything else at ``adam_eps=1e-3``; params and per-round losses ≤1e-5;
cost books exact.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import RoundSpec
from repro.fl import FLRunConfig, run_federated
from repro.launch import mesh as jmesh
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import aggregation, schedule as tsched
from repro_torch.fl.batched import make_engine
from repro_torch.launch import mesh as tmesh
from repro_torch.optim.adam import AdamConfig as TAdamConfig
from repro_torch.tree import tree_leaves, tree_paths
from tests.test_torch_fl_vmap import (BATCH, MIXED, TOL, _assert_runs_close,  # noqa: F401
                                      setup)

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TIERS = (0.34, 0.67, 1.0)
HETERO_MIXED = [MIXED[0], RoundSpec(index=1, phase="partial", cycle=0, group=4)]


def _both(setup, rounds, engines=("shard_map", "sequential"), **kw):
    """The reference's runs on ``engines`` and the port's shard_map run."""
    common = dict(local_epochs=1, batch_size=BATCH, lr=2e-3, **kw)
    common.setdefault("adam_eps", 1e-3)
    refs = [run_federated(setup["adapter"], setup["clients"], setup["eval"], rounds,
                          FLRunConfig(engine=e, **common), init_key=jax.random.key(0))
            for e in engines]
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
    port = tfl.run_federated(
        setup["tadapter"], setup["tclients"], setup["eval"], trounds,
        tfl.FLRunConfig(engine="shard_map", device="cpu", **common),
        init_params=bridge.from_numpy_tree(setup["init"]))
    for ref in refs:
        _assert_runs_close(ref.params, ref.history, port, TOL)
        assert (port.comm_total_bytes, port.comm_fnu_bytes, port.comp_total_flops,
                port.comp_fnu_flops) == (ref.comm_total_bytes, ref.comm_fnu_bytes,
                                         ref.comp_total_flops, ref.comp_fnu_flops)
    return port


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_nested_plan_matches_reference(setup, fused):
    _both(setup, HETERO_MIXED, plan="nested", capacity_tiers=TIERS, adam_eps=1e-2,
          fused_adam=fused)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_over_two_rounds_matches_reference(setup, kind):
    """Each client's update is compressed before the all-reduce with its
    error-feedback residual; the second round reads the first's."""
    _both(setup, MIXED, engines=("sequential",), compression=kind, topk_fraction=0.05,
          fused_adam=kind == "int8")


def test_fused_plan_keeps_untrained_groups_bit_exact(setup):
    """The fused plan splice scatters only the trained groups' rows: a group
    nobody trained on the partial round keeps the round-0 global exactly."""
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in HETERO_MIXED]
    cfg = dict(local_epochs=1, batch_size=BATCH, lr=2e-3, adam_eps=1e-2,
               plan="nested", capacity_tiers=TIERS, fused_adam=True, device="cpu")
    init = bridge.from_numpy_tree(setup["init"])
    one = tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                            trounds[:1], tfl.FLRunConfig(engine="shard_map", **cfg),
                            init_params=init)
    two = tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                            trounds, tfl.FLRunConfig(engine="shard_map", **cfg),
                            init_params=init)
    part = setup["tadapter"].partition(one.params)
    plan = tsched.PlanAssigner(num_groups=part.num_groups, kind="nested",
                               capacity_tiers=TIERS, seed=0).assign(trounds[1], [0, 1, 2])
    untrained = set(range(part.num_groups)) - set(np.flatnonzero(plan.any(axis=0)))
    assert untrained
    for (path, a), (_, b) in zip(tree_paths(one.params), tree_paths(two.params)):
        p = "/".join(path)
        if part.group_of(p) in untrained and not aggregation.is_local_stat(p):
            assert torch.equal(a, b), p


def test_client_mesh_helpers_match_reference():
    """A one-rank mesh (made in process when no group exists) is the
    reference's one-device mesh: the "clients" axis, no data-parallel
    axes, axis sizes; more devices than ranks raise with how to start
    them, as the reference names its host-device flag."""
    mesh = tmesh.make_client_mesh(0, "cpu")
    ref = jmesh.make_client_mesh(1)
    assert mesh.mesh_dim_names == ref.axis_names == ("clients",)
    assert tmesh.dp_axes(mesh) == jmesh.dp_axes(ref) == ()
    for name in ("clients", "data", "model"):
        assert tmesh.axis_size(mesh, name) == jmesh.axis_size(ref, name)
    assert tmesh.make_client_mesh(1, "cpu").size() == 1
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tmesh.make_client_mesh(2, "cpu")
    with pytest.raises(ValueError, match="host"):
        jmesh.make_client_mesh(len(jax.devices()) + 1)
    with pytest.raises(ValueError, match="nccl"):
        tmesh.make_client_mesh(0, "cuda")      # this group is gloo: no fallback
    with pytest.raises(ValueError, match="device type"):
        tmesh.make_client_mesh(0, "tpu")


def test_oversized_mesh_fails_the_run(setup):
    """``run_federated(engine="shard_map", sim_devices=N)`` with N above the
    world size fails before training, as the reference's does."""
    cfg = tfl.FLRunConfig(local_epochs=1, batch_size=BATCH, engine="shard_map",
                          sim_devices=2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                          tsched.FNUSchedule(1).rounds(), cfg,
                          init_params=bridge.from_numpy_tree(setup["init"]))


def test_rank_pool_slots(setup):
    """The async backend's slots: width 1, one per rank (one here), leased
    exclusively; a slot's results land on the rank's own device."""
    params = bridge.from_numpy_tree(setup["init"])
    part = setup["tadapter"].partition(params)
    trainer = tfl.LocalTrainer(adapter=setup["tadapter"], partition=part,
                               algo=tfl.AlgoConfig(), adam=TAdamConfig())
    engine = make_engine("shard_map", trainer=trainer, partition=part,
                         algo=tfl.AlgoConfig(), device_type="cpu")
    assert engine.cohort_pool(1, "cpu") is None
    pool = engine.cohort_pool(4, "cpu")
    assert pool.num_submeshes == 1 and pool.width == 1
    slot = pool.acquire()
    assert slot.ranks == (0,) and slot.device == torch.device("cpu")
    assert pool.acquire() is None
    pool.release(slot)
    with pytest.raises(ValueError, match="twice"):
        pool.release(slot)
    stacked, losses = engine.run_local_async(
        params, tsched.RoundSpec(0, "warmup", -1, -1), setup["tclients"],
        seeds=[1, 2, 3], epochs=1, batch_size=BATCH, submesh=slot)
    sharded, losses2 = engine.run_local_async(
        params, tsched.RoundSpec(0, "warmup", -1, -1), setup["tclients"],
        seeds=[1, 2, 3], epochs=1, batch_size=BATCH)
    assert torch.equal(losses, losses2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(stacked),
                                                 tree_leaves(sharded)))
