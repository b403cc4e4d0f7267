"""The port's async runtime (``repro_torch.fl.runtime``) against the JAX
package's, on the sequential engine.

Setup: the reference's own small one (``tests/test_async_runtime.py``):
ResNet-4, 4 classes, 8x8 synthetic images, 3 ragged clients (36 / 56 / 40
samples), batch 16, one local epoch, ``adam_eps=1e-3``, the reference's
initial parameters bridged over numpy, 2-4 FedPart versions.

* the policy merge (FedBuff, mixed full / partial / per-client-plan groups,
  staleness, inclusion probabilities) on the same bridged updates: ≤1e-6;
* the degenerate configuration (full participation, perfect fleet,
  ``buffer_k=0``, exponent 0) equals the port's sync path on both engines:
  ≤1e-5, books exact;
* no captured version-``v`` tree is written by a later merge (bit-exact);
* runs against the reference's ``run_federated_async``: FedBuff with
  staleness, dropout and two cohorts in flight, MOON, int8 compression.
  The timelines are equal event for event (kind, virtual time, clients,
  versions, groups, slots, books); only the merges' losses (≤1e-4) and the
  evals' accuracies (one eval sample) come from training.  Params ≤1e-4;
  cost books exact.

``test_torch_async_vmap.py`` runs the same reference comparisons on the vmap
engine; ``test_torch_async_control.py`` the controllers, traces and biased
cohorts.
"""

import re

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation, masking
from repro.core.schedule import FedPartSchedule
from repro.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                        make_vision_dataset)
from repro.fl import AlgoConfig, AvailabilityConfig, FLRunConfig, resnet_task, run_federated
from repro.fl.runtime.policy import ClientUpdate, make_policy
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import schedule as tsched
from repro_torch.data import pipeline as tpipe
from repro_torch.fl.batched import SequentialEngine
from repro_torch.fl.runtime import AvailabilityConfig as TAvailabilityConfig
from repro_torch.fl.runtime import ClientUpdate as TClientUpdate
from repro_torch.fl.runtime import make_policy as tmake_policy
from repro_torch.tree import tree_leaves, tree_map, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-4           # params and merge losses against the reference (sequential)
DEGENERATE_TOL = 1e-5
MERGE_TOL = 1e-6
BATCH = 16
N_EVAL = 64
ROUNDS = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                         cycles=1).rounds()
HETERO = dict(speed_spread=3.0, latency_jitter=0.2, dropout_prob=0.2, seed=5)
# name -> (rounds, run config fields, availability fields)
CONFIGS = {
    "fedbuff": (ROUNDS[:4], dict(buffer_k=1, staleness_exponent=0.5,
                                 sample_fraction=0.67, max_inflight_cohorts=2),
                HETERO),
    "moon": (ROUNDS[:3], dict(algo="moon", buffer_k=1, staleness_exponent=0.5,
                              sample_fraction=0.67),
             dict(speed_spread=3.0, latency_jitter=0.3, seed=5)),
    "int8": (ROUNDS[:3], dict(compression="int8", buffer_k=2,
                              staleness_exponent=0.5, max_inflight_cohorts=2),
             dict(speed_spread=2.0, dropout_prob=0.1, seed=3)),
}


def make_setup(sizes=(36, 56, 40)):
    spec = VisionDatasetSpec(num_classes=4, image_size=8)
    x, y = make_vision_dataset(spec, sum(sizes), seed=0)
    xe, ye = make_vision_dataset(spec, N_EVAL, seed=9)
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
    return make_setup()


def port_rounds(rounds):
    return [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]


def run_pair(setup, rounds, engine="sequential", fused=False, avail=None,
             ref_clients=None, port_clients=None, **kw):
    """The same async federation through the reference and the port:
    ``(reference FLResult, port FLResult)``."""
    algo = kw.pop("algo", "fedavg")
    common = dict(local_epochs=1, batch_size=BATCH, lr=2e-3, adam_eps=1e-3,
                  engine=engine, fused_adam=fused, runtime="async", **kw)
    avail = avail or {}
    ref = run_federated(
        setup["adapter"], setup["clients"] if ref_clients is None else ref_clients,
        setup["eval"], rounds,
        FLRunConfig(algo=AlgoConfig(name=algo),
                    availability=AvailabilityConfig(**avail), **common),
        init_key=jax.random.key(0))
    out = tfl.run_federated(
        setup["tadapter"], setup["tclients"] if port_clients is None else port_clients,
        setup["eval"], port_rounds(rounds),
        tfl.FLRunConfig(algo=tfl.AlgoConfig(name=algo),
                        availability=TAvailabilityConfig(**avail), device="cpu",
                        **common),
        init_params=bridge.from_numpy_tree(setup["init"]))
    return ref, out


_NUM = re.compile(r"(delta|util|mix|ep)=(-?[0-9.]+)")


def assert_notes_close(a: str, b: str, tol: float) -> None:
    """Control notes equal but for the training-derived numbers they print
    (a loss delta may round differently in its fourth decimal)."""
    assert _NUM.sub(r"\1=#", a) == _NUM.sub(r"\1=#", b), (a, b)
    for (ka, va), (_, vb) in zip(_NUM.findall(a), _NUM.findall(b)):
        assert abs(float(va) - float(vb)) <= (tol + 1e-4 if ka == "delta" else 0.0), (a, b)


def assert_timelines_equal(ref_tl, tl, tol):
    """Event for event: every field exact, but the merges' losses (``tol``),
    the evals' accuracies (one eval sample) and the control notes' loss
    deltas."""
    assert [e["kind"] for e in tl.events] == [e["kind"] for e in ref_tl.events]
    for a, b in zip(ref_tl.events, tl.events):
        assert set(a) == set(b), (a, b)
        for k in a:
            if a["kind"] == "merge" and k == "loss":
                assert abs(a[k] - b[k]) <= tol, (a, b)
            elif a["kind"] == "eval" and k == "acc":
                assert abs(a[k] - b[k]) <= 1.0 / N_EVAL + 1e-9, (a, b)
            elif a["kind"] == "control" and k == "note":
                assert_notes_close(a[k], b[k], tol)
            else:
                assert a[k] == b[k], (k, a, b)


def assert_params_close(ref_params, params, tol):
    ja = tree_paths(jax.tree.map(np.asarray, ref_params))
    tb = tree_paths(params)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, x), (_, y) in zip(ja, tb):
        np.testing.assert_allclose(y.detach().cpu().numpy(), x, rtol=tol, atol=tol,
                                   err_msg="/".join(path))


def assert_runs_match(ref, out, tol):
    assert_timelines_equal(ref.timeline, out.timeline, tol)
    assert_params_close(ref.params, out.params, tol)
    keys = ("round", "phase", "group", "t", "merged", "staleness_mean", "staleness_max")
    assert [{k: h[k] for k in keys} for h in out.history] == \
        [{k: h[k] for k in keys} for h in ref.history]
    np.testing.assert_allclose([h["loss"] for h in out.history],
                               [h["loss"] for h in ref.history], rtol=tol, atol=tol)
    for name in ("comm_total_bytes", "comm_fnu_bytes", "comp_total_flops",
                 "comp_fnu_flops"):
        assert getattr(out, name) == getattr(ref, name), name
    assert out.timeline.delivered_comm_bytes == ref.timeline.delivered_comm_bytes
    assert out.timeline.spent_comp_flops == ref.timeline.spent_comp_flops


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_async_matches_reference_sequential(setup, name):
    rounds, kw, avail = CONFIGS[name]
    ref, out = run_pair(setup, rounds, avail=avail, **kw)
    assert_runs_match(ref, out, TOL)
    tl = out.timeline
    assert len(tl.of_kind("merge")) == len(rounds)
    if name == "fedbuff":   # the configuration exercises what it names
        assert tl.of_kind("drop")
        assert max(h["staleness_max"] for h in out.history) >= 1
        assert tl.of_kind("occupancy")[0]["cohorts"] == len(tl.of_kind("dispatch"))


# -- the policy merge -----------------------------------------------------------


def test_policy_merge_matches_reference(setup):
    """One FedBuff merge of a mixed buffer — a full-network update, partial
    updates of two groups (one stale), and two per-client-plan updates with
    inclusion probabilities below 1 — on the same bridged values."""
    params_np = setup["init"]
    tparams = bridge.from_numpy_tree(params_np)
    jpart = setup["adapter"].partition(params_np)
    tpart = setup["tadapter"].partition(tparams)
    rng = np.random.default_rng(0)
    specs = [  # (client, version, group, groups, weight, inclusion_prob)
        (0, 3, -1, None, 36.0, 1.0), (1, 3, 2, None, 56.0, 1.0),
        (2, 1, 2, None, 40.0, 1.0), (3, 2, 4, None, 20.0, 1.0),
        (4, 3, 1, (1, 3), 30.0, 0.5), (5, 0, 0, (0, 1, 5), 25.0, 0.25)]
    jups, tups = [], []
    for cid, ver, group, groups, w, p in specs:
        noisy = jax.tree.map(
            lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype), params_np)
        sel = groups if groups is not None else (None if group < 0 else group)
        sub = noisy if sel is None else masking.select(noisy, jpart, sel)
        sub = aggregation.drop_local_stats(sub)
        common = dict(client_id=cid, version=ver, group=group, weight=w, loss=0.5,
                      dispatched_t=0.0, groups=groups, inclusion_prob=p)
        jups.append(ClientUpdate(subtree=sub, **common))
        tups.append(TClientUpdate(subtree=bridge.from_numpy_tree(sub), **common))
    jpol = make_policy("fedbuff", jpart, staleness_exponent=0.5, buffer_goal=4)
    tpol = tmake_policy("fedbuff", tpart, staleness_exponent=0.5, buffer_goal=4)
    jnew, jinfo = jpol.merge(params_np, jups, version=3)
    before = [t.clone() for t in tree_leaves(tparams)]
    tnew, tinfo = tpol.merge(tparams, tups, version=3)
    assert jinfo == tinfo
    assert_params_close(jnew, tnew, MERGE_TOL)
    # the merge built new leaves: the tree it was given is untouched
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tparams)))
    for buffered in (0, 1, 4):
        for pending in (0, 2):
            assert tpol.should_merge(buffered, pending, 3) == \
                jpol.should_merge(buffered, pending, 3)


# -- the degenerate configuration -------------------------------------------------


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_degenerate_async_equals_sync(setup, engine):
    """Full participation, perfect fleet, ``buffer_k=0``, exponent 0: every
    cohort is a barrier round, and the run equals the sync path."""
    runs = {}
    for runtime in ("sync", "async"):
        cfg = tfl.FLRunConfig(local_epochs=1, batch_size=BATCH, lr=2e-3,
                              adam_eps=1e-3, engine=engine, fused_adam=True,
                              runtime=runtime, device="cpu")
        runs[runtime] = tfl.run_federated(
            setup["tadapter"], setup["tclients"], setup["eval"],
            port_rounds(ROUNDS[:3]), cfg,
            init_params=bridge.from_numpy_tree(setup["init"]))
    sync, asy = runs["sync"], runs["async"]
    for a, b in zip(tree_leaves(sync.params), tree_leaves(asy.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=DEGENERATE_TOL,
                                   atol=DEGENERATE_TOL)
    np.testing.assert_allclose([h["loss"] for h in asy.history],
                               [h["loss"] for h in sync.history],
                               rtol=DEGENERATE_TOL, atol=DEGENERATE_TOL)
    for name in ("comm_total_bytes", "comm_fnu_bytes", "comp_total_flops",
                 "comp_fnu_flops"):
        assert getattr(asy, name) == getattr(sync, name), name
    assert len(asy.timeline.of_kind("merge")) == 3
    assert all(h["staleness_max"] == 0 for h in asy.history)
    assert set(asy.host_seconds) == {"dispatch", "launch", "resolve", "merge", "eval"}


def test_snapshots_stay_immutable(setup, monkeypatch):
    """Every tree a cohort was launched from is bit-identical, after the
    whole run, to a copy taken at its launch: later merges never wrote it."""
    captured = []
    orig = SequentialEngine.run_local_async

    def spy(self, params, *args, **kwargs):
        captured.append((params, tree_map(torch.clone, params)))
        return orig(self, params, *args, **kwargs)

    monkeypatch.setattr(SequentialEngine, "run_local_async", spy)
    rounds, kw, avail = CONFIGS["fedbuff"]
    cfg = tfl.FLRunConfig(local_epochs=1, batch_size=BATCH, lr=2e-3, adam_eps=1e-3,
                          runtime="async", device="cpu",
                          availability=TAvailabilityConfig(**avail), **kw)
    res = tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                            port_rounds(rounds), cfg,
                            init_params=bridge.from_numpy_tree(setup["init"]))
    assert len(captured) == len(res.timeline.of_kind("dispatch")) >= 3
    assert max(h["staleness_max"] for h in res.history) >= 1
    for live, copy in captured:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(live),
                                                     tree_leaves(copy)))


def test_async_config_validation(setup):
    with pytest.raises(ValueError, match="participation_sampling"):
        tfl.FLRunConfig(device="cpu", participation_sampling="greedy")
    with pytest.raises(ValueError, match="cohort_bounds"):
        tfl.FLRunConfig(device="cpu", controller_cohort_bounds=(0, 4))
    with pytest.raises(ValueError, match="participation_target"):
        tfl.FLRunConfig(device="cpu", controller_participation_target=1.5)
    with pytest.raises(ValueError, match="plan_boost_max"):
        tfl.FLRunConfig(device="cpu", controller_plan_boost_max=-1)
    with pytest.raises(ValueError, match="unknown runtime"):
        tfl.FLRunConfig(device="cpu", runtime="bulk")
    base = dict(device="cpu", local_epochs=1, batch_size=BATCH)
    rounds = port_rounds(ROUNDS[:1])
    init = bridge.from_numpy_tree(setup["init"])
    for kw, match in ((dict(participation_sampling="biased"), "async"),
                      (dict(runtime="async", track_stepsizes=True), "track_stepsizes"),
                      (dict(runtime="async", max_inflight_cohorts=0), "max_inflight"),
                      (dict(runtime="async", async_policy="eager"), "unknown policy"),
                      (dict(runtime="async", controller="greedy"), "unknown controller")):
        with pytest.raises(ValueError, match=match):
            tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                              rounds, tfl.FLRunConfig(**base, **kw), init_params=init)
    empty = tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"], [],
                              tfl.FLRunConfig(**base, runtime="async"),
                              init_params=init)
    assert empty.history == [] and empty.timeline.events == []
