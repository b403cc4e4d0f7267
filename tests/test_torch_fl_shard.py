"""The port's shard_map engine at world size 1, in process, against the JAX
package's ``ShardMapEngine`` on its one-device mesh, the reference's
sequential engine and the port's vmap engine.

Same setup as ``tests/test_torch_fl_vmap.py`` (ResNet-4, 3 ragged clients
of 36 / 56 / 40 synthetic 8x8 images, batch 16, the warm-up FNU round and
a partial round on group 0), for FedAvg / FedProx / MOON, fused (one
cohort masked-Adam launch per bucket and step, the packed
transmitted-rows epilogue; on the CPU the kernel's plain version) and
unfused (the per-leaf epilogue).  The mesh is a one-rank gloo group that
``launch.mesh.make_client_mesh`` makes in process, so every all-reduce and
all-gather is real but crosses no link (``test_torch_fl_shard_ranks.py``
runs two ranks).  Also here: the padded pipeline against the reference's,
the fused run's kernel steps against the bucket-steps recomputed from the
data, the bytes each round all-reduces against the transmitted rows, a
padding client that stays finite, and the async runtime on this engine.

Tolerances: f32, ``adam_eps=1e-3``, params and per-round losses ≤1e-5,
accuracy within one eval sample; cost books exact.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import FNUSchedule
from repro.data import pipeline as jpipe
from repro.fl import AlgoConfig, FLRunConfig, run_federated
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import aggregation, schedule as tsched
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import bucket_plans
from repro_torch.fl.batched import ShardMapEngine, _transmitted_rows, make_engine
from repro_torch.fl.population import client_round_seed
from repro_torch.kernels.masked_adam import MaskedAdamCohort
from repro_torch.optim.adam import AdamConfig as TAdamConfig
from repro_torch.tree import tree_paths
from tests.test_torch_fl_vmap import (BATCH, MIXED, TOL, _assert_runs_close,  # noqa: F401
                                      make_setup, setup)

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

_REF_SEQ: dict = {}


def _ref(setup, algo, engine, fused, rounds=MIXED):
    return run_federated(
        setup["adapter"], setup["clients"], setup["eval"], rounds,
        FLRunConfig(local_epochs=1, batch_size=BATCH, lr=2e-3, adam_eps=1e-3,
                    algo=AlgoConfig(name=algo), engine=engine, fused_adam=fused),
        init_key=jax.random.key(0))


def _port(setup, algo, engine, fused, rounds=MIXED, **kw):
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
    cfg = tfl.FLRunConfig(local_epochs=1, batch_size=BATCH, lr=2e-3, adam_eps=1e-3,
                          algo=tfl.AlgoConfig(name=algo), engine=engine,
                          fused_adam=fused, device="cpu", **kw)
    return tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                             trounds, cfg, init_params=bridge.from_numpy_tree(setup["init"]))


def _books(res):
    return (res.comm_total_bytes, res.comm_fnu_bytes, res.comp_total_flops,
            res.comp_fnu_flops)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("algo", ["fedavg", "fedprox", "moon"])
def test_shard_map_matches_reference_engines_and_vmap(setup, algo, fused):
    ref_shard = _ref(setup, algo, "shard_map", fused)
    if algo not in _REF_SEQ:
        _REF_SEQ[algo] = _ref(setup, algo, "sequential", False)
    ref_seq = _REF_SEQ[algo]
    shard = _port(setup, algo, "shard_map", fused)
    vmap = _port(setup, algo, "vmap", fused)
    _assert_runs_close(ref_shard.params, ref_shard.history, shard, TOL)
    _assert_runs_close(ref_seq.params, ref_seq.history, shard, TOL)
    _assert_runs_close(bridge.to_numpy_tree(vmap.params), vmap.history, shard, TOL)
    assert _books(shard) == _books(vmap) == _books(ref_shard) == _books(ref_seq)


def test_padded_buckets_match_the_reference_pipeline():
    """``pad_clients_to`` appends padding clients (the first member's
    batches, never valid) exactly as the reference's pipeline does."""
    s = make_setup((12, 36, 20, 40, 56))
    seeds = [3, 1, 4, 1, 5]
    for pad in (1, 2, 4):
        ref = jpipe.stack_client_batches(s["clients"], BATCH, 1, seeds, pad_clients_to=pad)
        got = tpipe.stack_client_batches(s["tclients"], BATCH, 1, seeds,
                                         pad_clients_to=pad)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.members == b.members and a.num_clients % pad == 0
            for field in ("inputs", "labels", "step_valid"):
                assert np.array_equal(getattr(a, field), np.asarray(getattr(b, field)))
    with pytest.raises(ValueError, match="pad_clients_to"):
        bucket_plans(s["tclients"], BATCH, 1, seeds, pad_clients_to=0)


def _engine(setup, fused=True):
    params = bridge.from_numpy_tree(setup["init"])
    part = setup["tadapter"].partition(params)
    trainer = tfl.LocalTrainer(adapter=setup["tadapter"], partition=part,
                               algo=tfl.AlgoConfig(), adam=TAdamConfig(lr=2e-3, eps=1e-3))
    return params, part, make_engine("shard_map", trainer=trainer, partition=part,
                                     algo=tfl.AlgoConfig(), fused_adam=fused,
                                     device_type="cpu")


def test_fused_kernel_steps_equal_the_bucket_steps(setup):
    """Each bucket's local step is one step of the cohort masked Adam on
    its rank (on the CPU the plain version, counted in ``plain_steps``;
    ``launches`` counts the card's kernel launches only)."""
    rounds = MIXED + FNUSchedule(2).rounds()
    expected = 0
    for spec in rounds:
        seeds = [client_round_seed(0, spec.index, c) for c in range(3)]
        expected += sum(plans.shape[1] for _, plans, _ in
                        bucket_plans(setup["tclients"], BATCH, 1, seeds))
    before, launches = MaskedAdamCohort.plain_steps, MaskedAdamCohort.launches
    _port(setup, "fedavg", "shard_map", True, rounds)
    # one bucket a round, its longest client (56 samples) 3 steps of 16
    assert MaskedAdamCohort.plain_steps - before == expected == 4 * 3
    assert MaskedAdamCohort.launches == launches


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_rounds_all_reduce_only_the_transmitted_update(setup, fused):
    """One all-reduce per bucket: the trained group's leaves, BN running
    moments never; fused, the packed transmitted rows (512 bytes a row)."""
    params, part, engine = _engine(setup, fused)
    ShardMapEngine.traffic = []
    for g in (-1, 0, 3):
        spec = tsched.RoundSpec(1, "partial" if g >= 0 else "warmup", 0, g)
        engine.run_round(params, spec, setup["tclients"], seeds=[1, 2, 3],
                         weights=[36, 56, 40], epochs=1, batch_size=BATCH)
    for rec, g in zip(ShardMapEngine.traffic, (-1, 0, 3)):
        sel = tuple(range(part.num_groups)) if g < 0 else g
        if fused:
            want = len(_transmitted_rows(params, part, sel)) * 512
        else:
            want = 4 * sum(
                x.numel() for p, x in tree_paths(params) if not aggregation.is_local_stat(
                    "/".join(p)) and (g < 0 or part.group_of("/".join(p)) == g))
        assert rec["group"] == g and rec["all_reduce_calls"] == 1
        assert rec["all_reduce_bytes"] == want
    stats = [p for p, _ in tree_paths(params) if aggregation.is_local_stat("/".join(p))]
    assert stats   # ResNet-4's BN moments exist and are excluded above


def test_padding_client_trains_nothing_and_stays_finite(setup):
    """A bucket padded 3 -> 4: the padding row (the first member's batches,
    no valid step) keeps the global params and a finite zero loss."""
    params, _, engine = _engine(setup)
    spec = tsched.RoundSpec(0, "warmup", -1, -1)
    (members, rows, stacked, losses), = engine._cohort_parts(
        params, spec, setup["tclients"], seeds=[1, 2, 3], epochs=1, batch_size=BATCH,
        prev_params=None, plan=None, pad_clients_to=4)
    assert members == (0, 1, 2) and rows == range(4)
    assert torch.isfinite(losses).all() and float(losses[3]) == 0.0
    for (_, x), (_, g) in zip(tree_paths(stacked), tree_paths(params)):
        assert torch.isfinite(x).all() and torch.equal(x[3], g)


@pytest.mark.parametrize("inflight", [1, 2])
def test_async_runtime_on_the_shard_map_engine(setup, inflight):
    """The degenerate async configuration equals the sync run on this
    engine (at in-flight 2 the pool has the one rank's slot)."""
    sync = _port(setup, "fedavg", "shard_map", True)
    asy = _port(setup, "fedavg", "shard_map", True, runtime="async",
                max_inflight_cohorts=inflight)
    _assert_runs_close(bridge.to_numpy_tree(sync.params), sync.history, asy, TOL)
    assert _books(sync) == _books(asy)
    assert len(asy.timeline.of_kind("merge")) == len(MIXED)
