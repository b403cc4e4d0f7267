"""The port's telemetry, cost books and device slots against the JAX
package's, on the same inputs.

* ``Timeline`` / ``TimelineWindow`` reducers over a seeded random event log
  (every reducer, several window spans), ``VirtualTimeModel``,
  ``SubmeshOccupancy``, the span helpers, ``plan_step_flops``, the Adam
  step book, ``debias_weights`` and ``total_param_bytes``: exact (float64
  host arithmetic, the same operations in the same order);
* ``estimate_k`` (random and group masks) and ``update_step_size`` on
  bridged trees: ≤1e-5 relative (f32 reductions);
* ``SubmeshPool`` acquire / release / exhaustion against the reference's on
  one device (the one CPU device, the one JAX device);
* ``track_stepsizes`` on the sequential engine against the reference's
  tracker (ResNet-4, a warm-up FNU round and a partial round, fused and
  unfused): step sizes ≤1e-5, boundaries exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro.core import telemetry as jtel
from repro.core.aggregation import debias_weights
from repro.core.partition import total_param_bytes
from repro.core.schedule import FedPartSchedule
from repro.fl import FLRunConfig, run_federated
from repro.launch.mesh import SubmeshPool
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import aggregation as tagg
from repro_torch.core import costs as tcosts
from repro_torch.core import partition as tpart
from repro_torch.core import telemetry as ttel
from repro_torch.launch import mesh as tmesh
from tests.test_torch_async import make_setup, port_rounds

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

STEP_TOL = 1e-5


def _event_log(seed: int, n: int = 80) -> list[dict]:
    """A seeded random async event log with every kind the runtime books."""
    rng = np.random.default_rng(seed)
    t, version, events = 0.0, 0, []
    for _ in range(n):
        t += float(rng.exponential(0.3)) * (rng.random() < 0.8)
        kind = rng.choice(["dispatch", "complete", "drop", "merge", "eval", "wait"],
                          p=[0.15, 0.4, 0.1, 0.15, 0.1, 0.1])
        if kind == "dispatch":
            e = dict(version=version, group=int(rng.integers(-1, 6)),
                     clients=[int(c) for c in rng.choice(50, 3, replace=False)],
                     t_end=t + float(rng.exponential(1.0)),
                     submesh=int(rng.integers(-1, 2)))
        elif kind == "complete":
            e = dict(client=int(rng.integers(0, 50)), staleness=int(rng.integers(0, 4)),
                     comm_bytes=int(rng.integers(100, 10_000)),
                     comp_flops=float(rng.uniform(1e3, 1e6)),
                     inclusion_prob=float(rng.choice([1.0, 0.5, 0.25, 0.8])),
                     tier=int(rng.integers(0, 3)))
        elif kind == "drop":
            e = dict(client=int(rng.integers(0, 50)), comp_flops=float(rng.uniform(1e3, 1e6)))
        elif kind == "merge":
            e = dict(version=version, group=int(rng.integers(-1, 3)),
                     loss=float(rng.uniform(0.5, 2.0)), merged=int(rng.integers(1, 4)),
                     staleness_mean=0.5, staleness_max=2)
            version += 1
        elif kind == "eval":
            e = dict(version=version, acc=float(rng.uniform(0, 1)))
        else:
            e = dict(until=t + 0.5, rejected=3)
        events.append((t, str(kind), e))
    return events


def _window_reducers(w, num_clients=50) -> dict:
    return {"t": (w.t_start, w.t_end, w.duration, w.merges, len(w.events)),
            "staleness": w.staleness_moments(),
            "mix": [w.discounted_mix(a) for a in (0.0, 0.5, 1.0)],
            "ep": (w.effective_participation(num_clients),
                   w.effective_participation(num_clients, inverse_probability=True)),
            "incl": w.inclusion_moments(), "tiers": w.tier_participation(3),
            "span": w.span_seconds(), "overlap": w.overlap_seconds(),
            "progress": w.group_progress()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeline_reducers_match_reference(seed):
    ja, tb = jtel.Timeline(), ttel.Timeline()
    for t, kind, fields in _event_log(seed):
        ja.record(t, kind, **fields)
        tb.record(t, kind, **fields)
    assert tb.events == ja.events
    for name in ("total_seconds", "delivered_comm_bytes", "spent_comp_flops"):
        assert getattr(tb, name) == getattr(ja, name), name
    assert tb.cohort_spans() == ja.cohort_spans()
    assert tb.overlap_seconds() == ja.overlap_seconds()
    assert tb.accuracy_curve() == ja.accuracy_curve()
    for thr in (0.2, 0.6, 0.99, 2.0):
        assert tb.time_to_accuracy(thr) == ja.time_to_accuracy(thr)
    for k in (1, 2, 4, 100):
        assert _window_reducers(tb.window(k)) == _window_reducers(ja.window(k))
    assert _window_reducers(ttel.Timeline().window()) == \
        _window_reducers(jtel.Timeline().window())
    with pytest.raises(ValueError):
        tb.window(0)


def test_cost_books_match_reference():
    setup = make_setup()
    jparams = setup["init"]
    tparams = bridge.from_numpy_tree(jparams)
    jp, tp = setup["adapter"].partition(jparams), setup["tadapter"].partition(tparams)
    counts = tpart.group_param_counts(tparams, tp).astype(np.float64)
    rng = np.random.default_rng(0)
    for _ in range(20):
        groups = tuple(int(g) for g in rng.choice(6, int(rng.integers(1, 7)), replace=False))
        for fwd in (None, counts):
            assert tcosts.plan_step_flops(tp, groups, fwd) == \
                jcosts.plan_step_flops(jp, groups, fwd)
    with pytest.raises(ValueError):
        tcosts.plan_step_flops(tp, ())
    assert tpart.total_param_bytes(tparams) == total_param_bytes(jparams)
    for n, frac in ((153_604, 1.0), (1_000, 0.25), (7, 0.0)):
        for fused in (True, False):
            assert tcosts.adam_step_bytes(n, fused=fused, trained_fraction=frac) == \
                jcosts.adam_step_bytes(n, fused=fused, trained_fraction=frac)
        assert tcosts.adam_step_flops(n, frac) == jcosts.adam_step_flops(n, frac)
        assert tcosts.fused_adam_traffic_ratio(frac) == jcosts.fused_adam_traffic_ratio(frac)
    assert tcosts.paper_asymptotic_comp_ratio(2.0) == jcosts.paper_asymptotic_comp_ratio(2.0)
    assert tcosts.comm_asymptotic_ratio(10) == jcosts.comm_asymptotic_ratio(10)
    for kw in (dict(), dict(flops_per_second=3e6, bytes_per_second=2e5,
                            base_latency_s=0.01)):
        jv, tv = jcosts.VirtualTimeModel(**kw), tcosts.VirtualTimeModel(**kw)
        for flops, nb, speed, jit in ((1e5, 4096, 1.0, 1.0), (3.3e7, 1e6, 0.37, 1.19)):
            assert tv.round_seconds(flops, nb, speed=speed, jitter=jit) == \
                jv.round_seconds(flops, nb, speed=speed, jitter=jit)
        with pytest.raises(ValueError):
            tv.round_seconds(1.0, 1.0, speed=0.0)
    spans = [(int(rng.integers(-1, 3)), float(s), float(s + d))
             for s, d in zip(rng.uniform(0, 10, 30), rng.exponential(2.0, 30))]
    jo, to = jcosts.VirtualTimeModel().occupancy(), tcosts.VirtualTimeModel().occupancy()
    for sm, s, e in spans:
        jo.book(sm, s, e)
        to.book(sm, s, e)
    assert to.summary() == jo.summary()
    assert to.busy_seconds() == jo.busy_seconds()
    plain = [(s, e) for _, s, e in spans]
    assert tcosts.overlap_of_spans(plain) == jcosts.overlap_of_spans(plain)
    assert tcosts.max_concurrency_of_spans(plain) == jcosts.max_concurrency_of_spans(plain)
    with pytest.raises(ValueError):
        to.book(0, 2.0, 1.0)


def test_debias_weights_match_reference():
    rng = np.random.default_rng(3)
    for dtype in (np.float32, np.float64):
        w = rng.uniform(1, 100, 9).astype(dtype)
        for probs in (np.ones(9), rng.uniform(0.05, 1.0, 9)):
            a, b = debias_weights(w, probs), tagg.debias_weights(w, probs)
            assert b.dtype == a.dtype and np.array_equal(a, b)
        assert tagg.debias_weights(w, np.ones(9)) is w     # the identity itself
    for bad in (np.zeros(9), np.full(9, 1.5), np.ones(4)):
        with pytest.raises(ValueError):
            tagg.debias_weights(np.ones(9), bad)


def test_step_size_and_estimate_k_match_reference():
    setup = make_setup()
    rng = np.random.default_rng(1)
    trees = [jax.tree.map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype),
                          setup["init"]) for _ in range(5)]
    ttrees = [bridge.from_numpy_tree(t) for t in trees]
    np.testing.assert_allclose(ttel.update_step_size(ttrees[0], ttrees[1]),
                               jtel.update_step_size(trees[0], trees[1]), rtol=STEP_TOL)
    jp = setup["adapter"].partition(trees[0])
    tp = setup["tadapter"].partition(ttrees[0])
    for masks in ("random", "groups"):
        np.testing.assert_allclose(
            ttel.estimate_k(ttrees, tp, ttrees[0], masks=masks, num_masks=8, seed=2),
            jtel.estimate_k(trees, jp, trees[0], masks=masks, num_masks=8, seed=2),
            rtol=STEP_TOL)
    jt, tt = jtel.StepSizeTracker(), ttel.StepSizeTracker()
    for s, b in ((1.0, False), (2.0, True), (1.5, False), (0.5, False), (3.0, True),
                 (1.0, False), (1.0, False), (2.0, False)):
        for tr in (jt, tt):
            if b:
                tr.mark_round_boundary()
            tr.sizes.append(s)
    assert tt.post_aggregation_spike(2) == jt.post_aggregation_spike(2)


def test_submesh_pool_matches_reference():
    jpool, tpool = SubmeshPool(3), tmesh.SubmeshPool(3, device_type="cpu")
    assert (tpool.num_submeshes, tpool.width, tpool.free_count) == \
        (jpool.num_submeshes, jpool.width, jpool.free_count) == (1, 1, 1)
    ja, ta = jpool.acquire(), tpool.acquire()
    assert ta.index == ja.index == 0 and ta.device == torch.device("cpu")
    assert tpool.acquire() is None and jpool.acquire() is None
    tpool.release(ta)
    jpool.release(ja)
    assert tpool.acquire() is ta and tpool.free_count == 0
    tpool.release(ta)
    with pytest.raises(ValueError, match="twice"):
        tpool.release(ta)
    with pytest.raises(ValueError, match="not from this pool"):
        tpool.release(dataclasses.replace(ta, index=5))
    with pytest.raises(ValueError, match="num_submeshes"):
        tmesh.SubmeshPool(0, device_type="cpu")
    with pytest.raises(ValueError, match="cannot cut"):
        tmesh.SubmeshPool(1, width=2, device_type="cpu")
    assert tmesh.visible_devices("cuda") == tuple(
        torch.device("cuda", i) for i in range(torch.cuda.device_count()))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_track_stepsizes_matches_reference(fused):
    setup = make_setup()
    rounds = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                             cycles=1).rounds()[:2]
    kw = dict(local_epochs=1, batch_size=16, lr=2e-3, adam_eps=1e-3,
              fused_adam=fused, track_stepsizes=True)
    ref = run_federated(setup["adapter"], setup["clients"], setup["eval"], rounds,
                        FLRunConfig(**kw), init_key=jax.random.key(0))
    out = tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                            port_rounds(rounds), tfl.FLRunConfig(device="cpu", **kw),
                            init_params=bridge.from_numpy_tree(setup["init"]))
    assert out.tracker.boundaries == ref.tracker.boundaries == [0, 2]
    assert len(out.tracker.sizes) == len(ref.tracker.sizes) == 4
    np.testing.assert_allclose(out.tracker.sizes, ref.tracker.sizes,
                               rtol=STEP_TOL, atol=STEP_TOL)
    with pytest.raises(ValueError, match="sequential"):
        tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                          port_rounds(rounds),
                          tfl.FLRunConfig(device="cpu", engine="vmap", **kw))
