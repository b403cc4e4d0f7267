"""The port's control loop, availability traces and biased cohorts against
the JAX package's.

* every controller's ``observe`` over the same sequence of windows (cut
  from seeded random event logs) and ``make_controller``'s bundles: the
  adjustments are equal field for field, notes included;
* ``ClientAvailability`` under the ``"diurnal"`` and ``"file"`` traces (JSON
  and ``.npz``): on/off windows, next on-times, weights, inclusion
  probabilities and the per-dispatch stream (arrivals, jitter, drops) equal
  the reference's exactly;
* async runs against the reference's on the sequential engine (ResNet-4,
  6 clients of 24 samples, batch 16, ``adam_eps=1e-3``): a file trace whose
  fleet is off at t=0, availability-biased cohorts with debiased merges on
  a skewed diurnal trace, and adaptive control (in-flight target, FedBuff
  goal, group repeats; then the participation and plan-boost knobs).
  Timelines equal event for event, ``"control"`` events included; params
  and merge losses ≤1e-4; books exact.  ``ProgressGroupController`` decides
  on merge-loss deltas, so each adaptive run first asserts that no delta it
  observed lies within the loss tolerance of its threshold: a decision that
  could flip between the two packages fails there, not as a flaky diff.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.schedule import FedPartSchedule
from repro.core.telemetry import Timeline
from repro.fl.runtime import clients as jcl
from repro.fl.runtime import control as jctl
from repro.fl import FLRunConfig
from repro_torch import fl as tfl
from repro_torch.core import telemetry as ttel
from repro_torch.fl.runtime import clients as tcl
from repro_torch.fl.runtime import control as tctl
from tests.test_torch_async import TOL, assert_runs_match, make_setup, run_pair
from tests.test_torch_telemetry import _event_log

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

ROUNDS = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                         cycles=1).rounds()
SKEWED = dict(trace="diurnal", trace_period=0.05, duty_cycle=(0.15, 0.9),
              unavailable_prob=0.4, speed_spread=2.0, seed=5)
HETERO = dict(speed_spread=3.0, latency_jitter=0.3, seed=5)


@pytest.fixture(scope="module")
def setup():
    return make_setup((24,) * 6)


# -- controllers on the same windows ----------------------------------------------


def _windows(seed, span):
    """The windows a controller would observe after each merge of a random
    log: ``(reference window, port window)`` pairs."""
    log = _event_log(seed, 120)
    ja, tb = Timeline(), ttel.Timeline()
    out = []
    for t, kind, fields in log:
        ja.record(t, kind, **fields)
        tb.record(t, kind, **fields)
        if kind == "merge":
            out.append((ja.window(span), tb.window(span)))
    return out


def _controllers(mod):
    return [mod.AdaptiveInflightController(bounds=(1, 4), current=1),
            mod.AdaptiveInflightController(bounds=(2, 3), current=3, grow_at=0.3,
                                           shrink_at=0.1),
            mod.StalenessBufferController(exponent=0.5, bounds=(1, 8), current=2),
            mod.StalenessBufferController(exponent=1.0, bounds=(1, 3), current=1,
                                          mix_floor=0.8),
            mod.ProgressGroupController(max_repeats=2),
            mod.ProgressGroupController(max_repeats=1, min_delta=0.1),
            mod.ParticipationController(target=0.3, bounds=(1, 16), current=4,
                                        num_clients=50),
            mod.ParticipationController(target=0.1, bounds=(2, 8), current=8,
                                        num_clients=50, debiased=True),
            mod.PlanAssignmentController(num_tiers=3, min_prefix=1, max_boost=2),
            mod.PlanAssignmentController(num_tiers=2, min_prefix=0, max_boost=1,
                                         min_delta=0.5)]


@pytest.mark.parametrize("span", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 3])
def test_controllers_observe_like_reference(seed, span):
    jparts, tparts = _controllers(jctl), _controllers(tctl)
    jparts.append(jctl.CompositeController(parts=tuple(_controllers(jctl))))
    tparts.append(tctl.CompositeController(parts=tuple(_controllers(tctl))))
    seen = 0
    for jw, tw in _windows(seed, span):
        for jc, tc in zip(jparts, tparts):
            ja, tb = jc.observe(jw), tc.observe(tw)
            assert vars(tb) == vars(ja)
            assert bool(tb) == bool(ja)
            seen += bool(ja)
    assert seen > 0          # the windows move the controllers
    a = tctl.PolicyAdjustment(max_inflight=2, note="a")
    b = jctl.PolicyAdjustment(max_inflight=2, note="a")
    assert vars(a.merged(tctl.PolicyAdjustment(buffer_k=3, note="b"))) == \
        vars(b.merged(jctl.PolicyAdjustment(buffer_k=3, note="b")))


@pytest.mark.parametrize("kw", [
    dict(), dict(controller="adaptive"),
    dict(controller="adaptive", max_inflight_cohorts=3, buffer_k=5,
         staleness_exponent=0.5, controller_participation_target=0.5,
         participation_sampling="biased", plan="nested",
         capacity_tiers=(0.3, 1.0), controller_plan_boost_max=2)])
def test_make_controller_like_reference(kw):
    ja = jctl.make_controller(FLRunConfig(**kw), num_clients=8, num_groups=6,
                              cohort_size=3)
    tb = tctl.make_controller(tfl.FLRunConfig(device="cpu", **kw), num_clients=8,
                              num_groups=6, cohort_size=3)
    if ja is None:
        assert tb is None
        return
    assert [type(p).__name__ for p in tb.parts] == [type(p).__name__ for p in ja.parts]
    assert [vars(p) for p in tb.parts] == [vars(p) for p in ja.parts]
    with pytest.raises(ValueError, match="controller_window"):
        tctl.make_controller(tfl.FLRunConfig(device="cpu", controller="adaptive",
                                             controller_window=0))


# -- availability traces ------------------------------------------------------------


def _trace_files(tmp_path):
    js = tmp_path / "trace.json"
    js.write_text(json.dumps({"period": 2.0, "duty": [0.25, 0.7, 1.0],
                              "phase": [0.5, 0.1, 0.0]}))
    npz = tmp_path / "trace.npz"
    np.savez(npz, duty=np.array([0.4, 0.9]), phase=np.array([0.3, 1.7]), period=3.0)
    return str(js), str(npz)


def test_traces_match_reference(tmp_path):
    js, npz = _trace_files(tmp_path)
    configs = [dict(trace="diurnal", duty_cycle=(0.2, 0.8), trace_period=4.0, seed=3),
               dict(trace="diurnal", duty_cycle=(0.2, 0.8), unavailable_prob=0.3,
                    dropout_prob=0.2, latency_jitter=0.5, speed_spread=2.0, seed=9),
               dict(trace="file", trace_path=js, unavailable_prob=0.1),
               dict(trace="file", trace_path=npz, seed=4),
               dict(unavailable_prob=0.4, seed=9), dict()]
    rng = np.random.default_rng(0)
    probes = [(int(c), float(t)) for c, t in zip(rng.integers(0, 10**6, 60),
                                                 rng.uniform(0, 20, 60))]
    for cfg in configs:
        ja = jcl.ClientAvailability(jcl.AvailabilityConfig(**cfg), 10**6)
        tb = tcl.ClientAvailability(tcl.AvailabilityConfig(**cfg), 10**6)
        assert tb.cfg.is_degenerate == ja.cfg.is_degenerate
        for cid, t in probes:
            assert tb.trace_on(cid, t) == ja.trace_on(cid, t)
            assert tb.next_on_time(cid, t) == ja.next_on_time(cid, t)
            assert tb.availability_weight(cid, t) == ja.availability_weight(cid, t)
            assert tb.inclusion_prob(cid) == ja.inclusion_prob(cid)
            assert tb.speed(cid) == ja.speed(cid)
            assert tb.arrival_ok(cid, t) == ja.arrival_ok(cid, t)
            assert tb.jitter() == ja.jitter() and tb.drops() == ja.drops()
        assert tb._rng.bit_generator.state == ja._rng.bit_generator.state
    for bad in (dict(trace="weekly"), dict(duty_cycle=(0.0, 0.5)),
                dict(trace="diurnal", trace_period=0.0), dict(trace="file"),
                dict(retry_wait=0.0), dict(dropout_prob=1.0)):
        with pytest.raises(ValueError):
            tcl.AvailabilityConfig(**bad)


# -- runs against the reference ---------------------------------------------------


def test_file_trace_run_matches_reference(setup, tmp_path):
    """Every client is off at t=0: the run books a wait, trains nobody until
    a window opens, and only ever dispatches on-window clients."""
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"period": 2.0, "duty": [0.25], "phase": [0.5]}))
    av = dict(trace="file", trace_path=str(p))
    ref, out = run_pair(setup, ROUNDS[:3], avail=av, sample_fraction=0.5,
                        buffer_k=1, staleness_exponent=0.5)
    assert_runs_match(ref, out, TOL)
    waits = out.timeline.of_kind("wait")
    assert waits and waits[0]["t"] == 0.0 and waits[0]["until"] == 1.0


@pytest.mark.parametrize("mode", ["blind", "biased"])
def test_biased_cohorts_match_reference(setup, mode):
    ref, out = run_pair(setup, ROUNDS[:4], avail=SKEWED, sample_fraction=0.5,
                        buffer_k=2, staleness_exponent=0.5,
                        participation_sampling=mode)
    assert_runs_match(ref, out, TOL)
    probs = {e["inclusion_prob"] for e in out.timeline.of_kind("complete")}
    if mode == "biased":     # the merges really were debiased
        assert probs and min(probs) < 1.0
    else:
        assert probs == {1.0}


def _observed_deltas(tl, window: int, total: int) -> list[float]:
    """The loss deltas ``ProgressGroupController`` saw after each merge of
    ``tl`` (it observes once the merge and its eval are recorded)."""
    events, deltas = tl.events, []
    merges = [i for i, e in enumerate(events) if e["kind"] == "merge"]
    for n, i in enumerate(merges[:-1] if len(merges) >= total else merges):
        end = i + 1 + (i + 1 < len(events) and events[i + 1]["kind"] == "eval")
        w = ttel.Timeline(events=list(events[:end])).window(window)
        ms = w.of_kind("merge")
        if len(ms) < 2 or int(ms[-1]["group"]) < 0:
            continue
        g = int(ms[-1]["group"])
        same = [e for e in ms if int(e["group"]) == g]
        deltas.append(w.group_progress()[g] if len(same) >= 2
                      else float(ms[-2]["loss"]) - float(ms[-1]["loss"]))
    return deltas


ADAPTIVE = {
    "inflight_buffer_repeat": (ROUNDS[:5], HETERO, dict(
        buffer_k=1, staleness_exponent=0.5, sample_fraction=0.34,
        controller="adaptive", controller_window=2)),
    "participation_plan": (ROUNDS[:5], SKEWED, dict(
        buffer_k=1, staleness_exponent=0.5, sample_fraction=0.34,
        participation_sampling="biased", controller="adaptive",
        controller_participation_target=0.6, controller_cohort_bounds=(1, 4),
        controller_window=2, plan="nested", capacity_tiers=(0.5, 1.0),
        controller_plan_boost_max=2)),
}


@pytest.mark.parametrize("name", sorted(ADAPTIVE))
def test_adaptive_run_matches_reference(setup, name):
    rounds, av, kw = ADAPTIVE[name]
    ref, out = run_pair(setup, rounds, avail=av, **kw)
    # the margin: no observed delta within the loss tolerance of min_delta (0)
    for tl in (ref.timeline, out.timeline):
        deltas = _observed_deltas(tl, kw["controller_window"], len(rounds))
        assert deltas and all(abs(d) > 2 * TOL for d in deltas), deltas
    assert_runs_match(ref, out, TOL)
    controls = out.timeline.of_kind("control")
    assert controls
    if name == "participation_plan":
        assert all(1 <= e["cohort_size"] <= 4 for e in controls)
