"""The port's population streaming (``repro_torch.fl.population``) against
the JAX package's.

* the samplers (Floyd, ``sample_excluding``, ``IncrementalSampler``, the
  weighted Efraimidis–Spirakis draw) return the reference's lists from the
  same generator seeds and leave the generator in the same state: exact;
* ``SyntheticPopulation`` shards, sizes and Dirichlet label skew equal the
  reference's bit for bit (vision and text specs);
* the state store keeps numpy leaves numpy through its spill, bit for bit
  (a shard cache with ``cache_dir``), as the reference's store does;
* a million-client population stays lazy: an async run over it costs the
  host what a run over 1,000 clients costs;
* a streamed run equals the materialised one in the port (exact), and the
  reference's ``run_federated`` on the same population: ≤1e-4 on the
  sequential engine, ≤1e-5 on the vmap engine (ResNet-4, batch 16,
  ``adam_eps=1e-3``, the reference's initial parameters bridged over numpy).
"""

import tracemalloc

import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import FedPartSchedule, FNUSchedule
from repro.data import TextDatasetSpec, VisionDatasetSpec, balanced_eval_set, make_vision_dataset
from repro.fl import FLRunConfig, resnet_task, run_federated
from repro.fl import population as jpop
from repro.fl.population.sampling import _nth_absent
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import schedule as tsched
from repro_torch.data import synthetic as tsynth
from repro_torch.fl import population as tpop
from repro_torch.fl.population.sampling import _nth_absent as t_nth_absent
from repro_torch.fl.population.store import ClientStateStore
from repro_torch.fl.runtime import AvailabilityConfig as TAvailabilityConfig
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

SPEC = VisionDatasetSpec(num_classes=4, image_size=8)
TSPEC = tsynth.VisionDatasetSpec(num_classes=4, image_size=8)
TOL = {"sequential": 1e-4, "vmap": 1e-5}


def _gens(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


# -- samplers ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_samplers_match_reference(seed):
    a, b = _gens(seed)
    for n, k in ((10, 3), (1000, 17), (1_000_000, 8), (5, 5), (4, 0)):
        assert tpop.sample_without_replacement(b, n, k) == \
            jpop.sample_without_replacement(a, n, k)
    busy = sorted(set(int(x) for x in a.integers(0, 1000, 40)))
    b.integers(0, 1000, 40)
    for k in (1, 8, 200):
        assert tpop.sample_excluding(b, 1000, k, busy) == \
            jpop.sample_excluding(a, 1000, k, busy)
    for rank in (0, 5, 500, 959):
        assert t_nth_absent(rank, busy) == _nth_absent(rank, busy)
    sa, sb = jpop.IncrementalSampler(a, 50, busy[:5]), tpop.IncrementalSampler(b, 50, busy[:5])
    for k in (3, 10, 40, 5):
        assert sb.draw(k) == sa.draw(k) and sb.remaining == sa.remaining
    ids = list(range(100, 130))
    w = a.random(30)
    w[::4] = 0.0
    b.random(30)
    for k in (0, 1, 5, 22):
        assert tpop.weighted_sample_without_replacement(b, ids, w, k) == \
            jpop.weighted_sample_without_replacement(a, ids, w, k)
    assert b.bit_generator.state == a.bit_generator.state
    with pytest.raises(ValueError):
        tpop.weighted_sample_without_replacement(b, ids, w, 29)
    with pytest.raises(ValueError):
        tpop.sample_excluding(b, 10, 9, [1, 2])


# -- synthetic populations -------------------------------------------------------


@pytest.mark.parametrize("kind,spc,alpha", [
    ("vision", 12, 0.0), ("vision", (8, 40), 0.5), ("text", (5, 20), 0.1)])
def test_synthetic_population_matches_reference(kind, spc, alpha):
    if kind == "vision":
        jspec, tspec = SPEC, TSPEC
    else:
        jspec = TextDatasetSpec(num_classes=4, vocab_size=64, seq_len=12)
        tspec = tsynth.TextDatasetSpec(num_classes=4, vocab_size=64, seq_len=12)
    ja = jpop.SyntheticPopulation(spec=jspec, population=200_000,
                                  samples_per_client=spc, alpha=alpha, seed=3)
    ta = tpop.SyntheticPopulation(spec=tspec, population=200_000,
                                  samples_per_client=spc, alpha=alpha, seed=3)
    for cid in (99_999, 0, 42, 42, 7):
        da, db = ja.dataset(cid), ta.dataset(cid)
        assert isinstance(db.inputs, np.ndarray) and db.inputs.dtype == da.inputs.dtype
        assert np.array_equal(db.inputs, da.inputs)
        assert np.array_equal(db.labels, da.labels)
        assert ta.num_samples(cid) == ja.num_samples(cid) == len(db)
        assert ta.capacity_tier(cid, 3) == ja.capacity_tier(cid, 3)
    if alpha:
        # the skew itself: per-client class histograms equal the reference's
        for cid in range(6):
            assert np.array_equal(np.bincount(ta.dataset(cid).labels, minlength=4),
                                  np.bincount(ja.dataset(cid).labels, minlength=4))
    with pytest.raises(IndexError):
        ta.dataset(200_000)
    with pytest.raises(ValueError, match="refusing to materialize"):
        ta.materialize()
    for bad in (dict(population=0), dict(population=4, alpha=-1.0),
                dict(population=4, samples_per_client=(5, 2))):
        with pytest.raises(ValueError):
            tpop.SyntheticPopulation(spec=tspec, **bad)


def test_store_spills_numpy_leaves(tmp_path):
    """Numpy entries (the shard cache's ``{"inputs", "labels"}``) come back
    numpy, same dtype, bit for bit, from memory and from a spill; tensor
    entries keep their behaviour beside them."""
    store = ClientStateStore(max_entries=1, spill_dir=str(tmp_path))
    rng = np.random.default_rng(0)
    entries = {c: {"inputs": rng.normal(size=(5, 8, 8, 3)).astype(np.float32),
                   "labels": rng.integers(0, 4, 5).astype(np.int32)} for c in range(2)}
    # a view into a larger buffer is spilled as its own bytes
    entries[1]["inputs"] = entries[1]["inputs"][1:4]
    for c, e in entries.items():
        store.put("data", c, e)
    store.put("ef", 7, {"w": torch.arange(6.0).reshape(2, 3)[1]})
    assert store.stats()["spills"] == 2
    for c, e in entries.items():
        back = store.get("data", c)
        for key in ("inputs", "labels"):
            assert isinstance(back[key], np.ndarray)
            assert back[key].dtype == e[key].dtype and back[key].shape == e[key].shape
            assert np.array_equal(back[key].view(np.uint8), e[key].view(np.uint8))
    res = store.get("ef", 7)
    assert isinstance(res["w"], torch.Tensor) and res["w"].tolist() == [3.0, 4.0, 5.0]
    assert store.stats()["loads"] == 3


def test_population_cache_spill_round_trip(tmp_path):
    ta = tpop.SyntheticPopulation(spec=TSPEC, population=10, samples_per_client=8,
                                  seed=0, cache_entries=2, cache_dir=str(tmp_path))
    ja = jpop.SyntheticPopulation(spec=SPEC, population=10, samples_per_client=8,
                                  seed=0, cache_entries=0)
    first = {c: ta.dataset(c).inputs.copy() for c in range(6)}
    assert ta.cache_stats()["spills"] > 0
    for c in range(6):                   # reloaded from the spill: exact
        assert np.array_equal(ta.dataset(c).inputs, first[c])
        assert np.array_equal(first[c], ja.dataset(c).inputs)
    assert ta.cache_stats()["loads"] > 0


# -- runs ------------------------------------------------------------------------------


def _eval_set():
    xe, ye = make_vision_dataset(SPEC, 64, seed=9)
    return balanced_eval_set(xe, ye, per_class=8)


@pytest.fixture(scope="module")
def pops():
    adapter = resnet_task("resnet4", num_classes=4)
    return {"jpop": jpop.SyntheticPopulation(spec=SPEC, population=8,
                                             samples_per_client=(16, 40), seed=3),
            "tpop": tpop.SyntheticPopulation(spec=TSPEC, population=8,
                                             samples_per_client=(16, 40), seed=3),
            "adapter": adapter, "tadapter": tfl.resnet_task("resnet4", num_classes=4),
            "init": jax.tree.map(np.asarray, adapter.init(jax.random.key(0))),
            "eval": _eval_set()}


def _tcfg(**kw):
    return tfl.FLRunConfig(local_epochs=1, batch_size=16, lr=2e-3, adam_eps=1e-3,
                           device="cpu", **kw)


def _port_run(pops, clients, rounds, **kw):
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
    return tfl.run_federated(pops["tadapter"], clients, pops["eval"], trounds,
                             _tcfg(**kw), init_params=bridge.from_numpy_tree(pops["init"]))


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_streamed_run_matches_materialised(pops, engine):
    rounds = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                             cycles=1).rounds()[:3]
    kw = dict(engine=engine, sample_fraction=0.5, algo=tfl.AlgoConfig(name="moon"))
    a = _port_run(pops, pops["tpop"], rounds, **kw)
    b = _port_run(pops, pops["tpop"].materialize(), rounds, **kw)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_streamed_run_matches_reference(pops, engine):
    """Sync FedPart over the streamed population, half of it per round, and
    the async runtime (degenerate but for the cohort) on the sequential
    engine: the reference's run on its own population of the same seed."""
    rounds = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1,
                             cycles=1).rounds()[:3]
    runtimes = ("sync", "async") if engine == "sequential" else ("sync",)
    for runtime in runtimes:
        kw = dict(engine=engine, sample_fraction=0.5, runtime=runtime,
                  fused_adam=engine == "vmap")
        ref = run_federated(pops["adapter"], pops["jpop"], pops["eval"], rounds,
                            FLRunConfig(local_epochs=1, batch_size=16, lr=2e-3,
                                        adam_eps=1e-3, **kw),
                            init_key=jax.random.key(0))
        out = _port_run(pops, pops["tpop"], rounds, **kw)
        tol = TOL[engine]
        np.testing.assert_allclose([h["loss"] for h in out.history],
                                   [h["loss"] for h in ref.history], rtol=tol, atol=tol)
        for (path, x), (_, y) in zip(tree_paths(jax.tree.map(np.asarray, ref.params)),
                                     tree_paths(out.params)):
            np.testing.assert_allclose(y.numpy(), x, rtol=tol, atol=tol,
                                       err_msg="/".join(path))
        assert out.comm_total_bytes == ref.comm_total_bytes
        assert out.comp_total_flops == ref.comp_total_flops
        if runtime == "async":
            assert [e["clients"] for e in out.timeline.of_kind("dispatch")] == \
                [e["clients"] for e in ref.timeline.of_kind("dispatch")]


def test_million_client_population_stays_lazy(pops):
    """An async FNU round with two clients per dispatch over 10**6 clients
    (speeds, arrivals, shards all per sampled id) takes the host the memory
    it takes over 10**3 clients: nothing is O(population)."""
    peaks = {}
    for n in (1_000, 1_000_000):
        pop = tpop.SyntheticPopulation(spec=TSPEC, population=n,
                                       samples_per_client=16, seed=0)
        kw = dict(cohort_size=2, runtime="async",
                  availability=TAvailabilityConfig(speed_spread=2.0,
                                                   unavailable_prob=0.3, seed=1))
        _port_run(pops, pop, FNUSchedule(1).rounds(), **kw)     # warm caches
        tracemalloc.start()
        res = _port_run(pops, pop, FNUSchedule(2).rounds(), **kw)
        peaks[n] = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        disp = res.timeline.of_kind("dispatch")
        assert disp and all(len(e["clients"]) == 2 and max(e["clients"]) < n
                            for e in disp)
    # one float per client would be 8 MB at 10**6; the two runs differ by
    # far less than that
    assert peaks[1_000_000] < peaks[1_000] + 1_000_000, peaks
