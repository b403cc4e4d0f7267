"""The port's core, data and population modules against the JAX package's.

Same numpy inputs (from seeds) through both; partition group ids, schedule
round lists, batch plans, datasets, cohort samples, seeds and cost books
must be exactly equal (they are integer / host-float arithmetic on the same
values).  Aggregates are f32 weighted sums accumulated in the same client
order in both packages; they agree to ≤1e-6 (float rounding of the sums is
the only difference).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import compress as jcompress
from repro.core import costs as jcosts
from repro.core import masking as jmask
from repro.core import schedule as jsched
from repro.core.partition import group_param_counts as jgc
from repro.data import partitioner as jpart
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.fl.population import sampling as jsamp
from repro.fl.tasks import resnet_task
from repro_torch import bridge
from repro_torch.core import aggregation as tagg
from repro_torch.core import compress as tcompress
from repro_torch.core import costs as tcosts
from repro_torch.core import masking as tmask
from repro_torch.core import schedule as tsched
from repro_torch.core.partition import group_param_counts as tgc
from repro_torch.data import partitioner as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import tasks as ttasks
from repro_torch.fl.population import sampling as tsamp
from repro_torch.fl.population import store as tstore
from repro_torch.tree import tree_paths

# One torch thread per test process (see test_torch_masked_adam.py).
torch.set_num_threads(1)

AGG_TOL = 1e-6


@pytest.fixture(scope="module")
def resnet8():
    """(JAX params as numpy, JAX partition, port params, port partition)."""
    adapter = resnet_task("resnet8")
    params = jax.tree.map(np.asarray, adapter.init(jax.random.key(0)))
    tparams = bridge.from_numpy_tree(params)
    return (params, adapter.partition(params), tparams,
            ttasks.resnet_task("resnet8").partition(tparams))


def _specs(rounds):
    return [(r.index, r.phase, r.cycle, r.group) for r in rounds]


def test_partition_group_ids_identical(resnet8):
    _, jp, _, tp = resnet8
    assert tp.group_keys == jp.group_keys
    assert dict(tp.assignment) == dict(jp.assignment)
    assert tp.num_groups == 10


@pytest.mark.parametrize("kw", [
    dict(num_groups=10, warmup_rounds=2, rounds_per_layer=1, cycles=1),
    dict(num_groups=6, warmup_rounds=1, rounds_per_layer=2, cycles=3,
         bridge_rounds=2),
    dict(num_groups=5, warmup_rounds=0, cycles=2, order="reverse"),
    dict(num_groups=7, warmup_rounds=3, cycles=3, order="random", seed=11),
])
def test_schedules_identical(kw):
    js, ts = jsched.FedPartSchedule(**kw), tsched.FedPartSchedule(**kw)
    assert _specs(ts.rounds()) == _specs(js.rounds())
    assert ts.total_rounds == js.total_rounds
    assert _specs(tsched.matched_fnu(ts).rounds()) == \
        _specs(jsched.matched_fnu(js).rounds())
    assert _specs(tsched.FNUSchedule(9).rounds()) == \
        _specs(jsched.FNUSchedule(9).rounds())


@pytest.mark.parametrize("kind,tiers", [("nested", (0.3, 0.6, 1.0)),
                                        ("random", (0.5, 1.0)),
                                        ("homogeneous", ())])
def test_plan_assigner_identical(kind, tiers):
    ja = jsched.PlanAssigner(num_groups=6, kind=kind, capacity_tiers=tiers, seed=4)
    ta = tsched.PlanAssigner(num_groups=6, kind=kind, capacity_tiers=tiers, seed=4)
    for spec in jsched.FedPartSchedule(num_groups=6, warmup_rounds=1).rounds():
        a = ja.assign(spec, [0, 3, 5, 8])
        b = ta.assign(tsched.RoundSpec(*_specs([spec])[0]), [0, 3, 5, 8])
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("n,bs,epochs,seed", [(500, 64, 1, 7), (36, 16, 3, 0),
                                              (5, 8, 2, 123456789)])
def test_batch_plan_identical(n, bs, epochs, seed):
    a = jpipe.batch_plan(n, bs, epochs, seed)
    b = tpipe.batch_plan(n, bs, epochs, seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_datasets_and_partitions_identical():
    vs = (jsyn.VisionDatasetSpec(), tsyn.VisionDatasetSpec())
    for (xa, ya), (xb, yb) in [(jsyn.make_vision_dataset(vs[0], 64, seed=3),
                                tsyn.make_vision_dataset(vs[1], 64, seed=3))]:
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    ta = jsyn.make_text_dataset(jsyn.TextDatasetSpec(), 16, seed=2)
    tb = tsyn.make_text_dataset(tsyn.TextDatasetSpec(), 16, seed=2)
    assert all(np.array_equal(a, b) for a, b in zip(ta, tb))
    labels = jsyn.make_vision_dataset(vs[0], 400, seed=1)[1]
    for a, b in [(jpart.iid_partition(400, 8, seed=0), tpart.iid_partition(400, 8, seed=0)),
                 (jpart.dirichlet_partition(labels, 6, 0.3, seed=2),
                  tpart.dirichlet_partition(labels, 6, 0.3, seed=2))]:
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    x, y = jsyn.make_vision_dataset(vs[0], 400, seed=5)
    ea, eb = (jpipe.balanced_eval_set(x, y, per_class=7),
              tpipe.balanced_eval_set(x, y, per_class=7))
    assert np.array_equal(ea[0], eb[0]) and np.array_equal(ea[1], eb[1])


def test_sampling_and_seeds_identical():
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    for n, k in [(8, 8), (100, 7), (10**6, 12), (3, 1)]:
        assert jsamp.sample_without_replacement(ra, n, k) == \
            tsamp.sample_without_replacement(rb, n, k)
    for s, r, c in [(0, 0, 0), (0, 23, 7), (9, 4, 10**6 + 3)]:
        assert jsamp.client_round_seed(s, r, c) == tsamp.client_round_seed(s, r, c)
    for args in [(8, 1.0, 0), (10, 0.25, 0), (10, 0.5, 3), (4, 1.0, 9)]:
        assert jsamp.resolve_cohort_size(*args) == tsamp.resolve_cohort_size(*args)


def _client_trees(params, n, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: (a + rng.standard_normal(a.shape)).astype(a.dtype),
                         params) for _ in range(n)]


def _assert_close(jtree, ttree, tol):
    ja, tb = tree_paths(jax.tree.map(np.asarray, jtree)), tree_paths(ttree)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        np.testing.assert_allclose(b.numpy(), a, rtol=tol, atol=tol,
                                   err_msg="/".join(path))


def test_aggregation_full_and_partial(resnet8):
    params, jp, tparams, tp = resnet8
    clients = _client_trees(params, 3, seed=1)
    tclients = [bridge.from_numpy_tree(c) for c in clients]
    weights = [36, 56, 40]
    _assert_close(jagg.aggregate_full(params, clients, weights),
                  tagg.aggregate_full(tparams, tclients, weights), AGG_TOL)
    for g in (0, 5, 9):
        subs = [jmask.select(c, jp, g) for c in clients]
        tsubs = [tmask.select(c, tp, g) for c in tclients]
        _assert_close(jagg.aggregate_partial(params, subs, weights),
                      tagg.aggregate_partial(tparams, tsubs, weights), AGG_TOL)
    _assert_close(jagg.tree_mean(clients), tagg.tree_mean(tclients), AGG_TOL)
    # BN running moments never travel: the aggregate keeps the global's
    out = tagg.aggregate_full(tparams, tclients, weights)
    for path, leaf in tree_paths(out):
        if tagg.is_local_stat("/".join(path)):
            node = tparams
            for k in path:
                node = node[k]
            assert torch.equal(leaf, node)
    with pytest.raises(ValueError):
        tagg.aggregate_full(tparams, tclients, [0, 0, 0])


def test_local_stat_filters(resnet8):
    params, _, tparams, _ = resnet8
    for path, _ in tree_paths(params):
        p = "/".join(path)
        assert jagg.is_local_stat(p) == tagg.is_local_stat(p)
    ja = jagg.drop_local_stats(params)
    tb = tagg.drop_local_stats(tparams)
    assert [p for p, _ in tree_paths(ja)] == [p for p, _ in tree_paths(tb)]


def test_masking_select_merge_roundtrip(resnet8):
    params, jp, tparams, tp = resnet8
    for groups in (3, (0, 9), tuple(range(10))):
        sel, comp = tmask.select(tparams, tp, groups), tmask.complement(tparams, tp, groups)
        assert [p for p, _ in tree_paths(sel)] == \
            [p for p, _ in tree_paths(jmask.select(params, jp, groups))]
        merged = tmask.merge(sel, comp)
        assert [p for p, _ in tree_paths(merged)] == [p for p, _ in tree_paths(tparams)]
    with pytest.raises(ValueError):
        tmask.merge(tparams, tparams)


def test_cost_books_identical(resnet8):
    params, jp, tparams, tp = resnet8
    sched = jsched.FedPartSchedule(num_groups=10, warmup_rounds=2,
                                   rounds_per_layer=1, cycles=2, bridge_rounds=1)
    for rounds in (sched.rounds(), jsched.matched_fnu(sched).rounds()):
        ja, tb = jcosts.comm_cost(params, jp, rounds), tcosts.comm_cost(tparams, tp, rounds)
        assert np.array_equal(ja.per_round_bytes, tb.per_round_bytes)
        assert (ja.total_bytes, ja.fnu_total_bytes) == (tb.total_bytes, tb.fnu_total_bytes)
        gw = jgc(params, jp).astype(np.float64)
        assert np.array_equal(gw, tgc(tparams, tp).astype(np.float64))
        for book in ("truncated", "paper"):
            jc = jcosts.comp_cost(jp, rounds, group_fwd_flops=gw, bookkeeping=book)
            tc = tcosts.comp_cost(tp, rounds, group_fwd_flops=gw, bookkeeping=book)
            assert np.array_equal(jc.per_round_flops, tc.per_round_flops)
            assert (jc.total_flops, jc.fnu_total_flops) == (tc.total_flops, tc.fnu_total_flops)
    # compression=... prices the encoded wire format (payload, scales, indices)
    for kind in ("int8", "onebit", "topk"):
        jcfg = jcompress.make_config(kind, block_rows=8)
        tcfg = tcompress.make_config(kind, block_rows=8)
        ja = jcosts.comm_cost(params, jp, sched.rounds(), compression=jcfg)
        tb = tcosts.comm_cost(tparams, tp, sched.rounds(), compression=tcfg)
        assert np.array_equal(ja.per_round_bytes, tb.per_round_bytes)
        assert (ja.total_bytes, ja.fnu_total_bytes) == (tb.total_bytes, tb.fnu_total_bytes)
        assert tb.total_bytes < tcosts.comm_cost(tparams, tp, sched.rounds()).total_bytes


def test_state_store_unbounded_only(tmp_path):
    """Unbounded by default (``max_entries=0``); bounded, an evicted entry
    is spilled to ``spill_dir`` and reloads value-exact, or is dropped
    without one."""
    store = tstore.ClientStateStore()
    assert store.get("moon", 3) is None
    store.put("moon", 3, {"w": torch.ones(2)})
    assert ("moon", 3) in store and len(store) == 1
    for c in range(5):
        store.put("ef", c, {"w": torch.full((2,), float(c))})
    assert len(store) == 6 and store.stats()["evictions"] == 0
    spill = tstore.ClientStateStore(max_entries=2, spill_dir=str(tmp_path / "spill"))
    drop = tstore.ClientStateStore(max_entries=2)
    big = torch.arange(12.0).reshape(3, 4)
    for s in (spill, drop):
        for c in range(3):
            s.put("moon", c, {"w": big[c]})        # views of one buffer
    assert len(spill) == len(drop) == 2 and ("moon", 0) in spill and ("moon", 0) not in drop
    assert drop.get("moon", 0) is None
    got = spill.get("moon", 0)
    assert torch.equal(got["w"], big[0]) and got["w"].untyped_storage().nbytes() == 16
    assert spill.stats() == {"in_memory": 2, "on_disk": 2, "evictions": 2, "spills": 2,
                             "loads": 1, "max_entries": 2}
