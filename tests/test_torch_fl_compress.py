"""Compressed transmitted subtrees through both of the port's engines against
the JAX package, end to end (``FLRunConfig(compression=...)``).

Mirrors the compression block of ``tests/test_engine_equivalence.py``: the
mixed schedule (one FNU warm-up round, then a partial round), FedAvg,
``fused_adam=True``, error feedback on, residuals keyed by client id.

* int8 and topk, on ResNet-4 (``test_torch_fl_vmap.py``'s setup) and on the
  nlp transformer at smoke size (``test_torch_fl_nlp.py``'s): the port's
  vmap and sequential engines against the reference's ``VmapEngine``;
* onebit: the port's sequential engine against the reference's (the
  reference leaves onebit out of its cross-engine checks: a ~1e-7
  difference can flip a sign, which moves an element by a whole scale);
* int8 under nested per-client plans (``transmit_tree_plan`` on the vmap
  engine, the structural selection on the sequential one);
* MOON with int8 through a bounded ``ClientStateStore`` (one entry in
  memory, the rest spilled to disk): bit for bit the unbounded run, and
  the reference's bounded run within tolerance; the store itself against
  the reference's on the same sequence of puts and gets.

Tolerance: the reference's ``COMPRESS_TOL = 5e-5`` on params and per-round
losses (one flipped int8 bin or top-k threshold costs more than the
uncompressed 1e-5); the encoded byte books exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import RoundSpec
from repro.fl import AlgoConfig, FLRunConfig, run_federated
from repro.fl.population import ClientStateStore as JStore
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import schedule as tsched
from repro_torch.fl.population import ClientStateStore
from repro_torch.tree import tree_paths
from tests import test_torch_fl_nlp, test_torch_fl_vmap

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

COMPRESS_TOL = 5e-5
BATCH = 16


@pytest.fixture(scope="module")
def resnet():
    return test_torch_fl_vmap.make_setup((36, 56, 40))


@pytest.fixture(scope="module")
def nlp():
    return test_torch_fl_nlp.make_setup()


def _assert_close(a_params, a_hist, b, tol=COMPRESS_TOL):
    ja = tree_paths(jax.tree.map(np.asarray, a_params))
    tb = tree_paths(b.params)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, x), (_, y) in zip(ja, tb):
        np.testing.assert_allclose(y.detach().cpu().numpy(), x, rtol=tol, atol=tol,
                                   err_msg="/".join(path))
    np.testing.assert_allclose([h["loss"] for h in b.history],
                               [h["loss"] for h in a_hist], rtol=tol, atol=tol)


def _port_run(setup, rounds, engine, algo="fedavg", **kw):
    cfg = tfl.FLRunConfig(algo=tfl.AlgoConfig(name=algo), engine=engine, device="cpu",
                          **kw)
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
    return tfl.run_federated(setup["tadapter"], setup["tclients"], setup["eval"],
                             trounds, cfg, init_params=bridge.from_numpy_tree(setup["init"]))


def _run(setup, rounds, ref_engine, port_engines, algo="fedavg", **kw):
    """The reference's run on ``ref_engine`` and the port's on each of
    ``port_engines``; all cost books equal the reference's exactly."""
    kw = dict(local_epochs=1, batch_size=BATCH, lr=2e-3, fused_adam=True, **kw)
    kw.setdefault("adam_eps", 1e-3)
    ref = run_federated(setup["adapter"], setup["clients"], setup["eval"], rounds,
                        FLRunConfig(algo=AlgoConfig(name=algo), engine=ref_engine, **kw),
                        init_key=jax.random.key(0))
    out = {}
    for engine in port_engines:
        res = out[engine] = _port_run(setup, rounds, engine, algo=algo, **kw)
        assert (res.comm_total_bytes, res.comm_fnu_bytes) == \
            (ref.comm_total_bytes, ref.comm_fnu_bytes)
        assert (res.comp_total_flops, res.comp_fnu_flops) == \
            (ref.comp_total_flops, ref.comp_fnu_flops)
    return ref, out


@pytest.mark.parametrize("kind", ["int8", "topk"])
@pytest.mark.parametrize("task", ["resnet", "nlp"])
def test_compressed_engines_match_reference(request, task, kind):
    setup = request.getfixturevalue(task)
    rounds = (test_torch_fl_vmap.MIXED if task == "resnet"
              else test_torch_fl_nlp.SCHEDULES["mixed"])
    ref, out = _run(setup, rounds, "vmap", ("vmap", "sequential"), compression=kind)
    for res in out.values():
        _assert_close(ref.params, ref.history, res)
    # the book prices the encoded wire format, below the dense one
    assert ref.comm_total_bytes < ref.comm_fnu_bytes


def test_onebit_matches_reference(nlp):
    ref, out = _run(nlp, test_torch_fl_nlp.SCHEDULES["mixed"], "sequential",
                    ("sequential",), compression="onebit")
    _assert_close(ref.params, ref.history, out["sequential"])


def test_int8_nested_plan_matches_reference(resnet):
    rounds = [test_torch_fl_vmap.MIXED[0],
              RoundSpec(index=1, phase="partial", cycle=0, group=4)]
    ref, out = _run(resnet, rounds, "vmap", ("vmap", "sequential"), compression="int8",
                    plan="nested", capacity_tiers=(0.34, 0.67, 1.0), adam_eps=1e-2)
    for res in out.values():
        _assert_close(ref.params, ref.history, res)


def test_spilled_state_reloads_bit_exact(nlp, tmp_path):
    """MOON prevs and EF residuals through a store that holds one entry in
    memory: every other entry crosses the disk between rounds.  (The
    reference spills ``.pkl`` files, the port ``.pt`` ones; each run writes
    an entry before it reads it back.)"""
    rounds = test_torch_fl_nlp.SCHEDULES["fedpart"][:3]
    kw = dict(algo="moon", compression="int8", compression_block_rows=1)
    ref, out = _run(nlp, rounds, "sequential", ("sequential", "vmap"),
                    state_store_entries=1, state_store_spill=str(tmp_path), **kw)
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".pkl"] * 6 + [".pt"] * 6
    for engine, res in out.items():
        _assert_close(ref.params, ref.history, res)
        unbounded = _port_run(nlp, rounds, engine, local_epochs=1, batch_size=BATCH,
                              lr=2e-3, adam_eps=1e-3, fused_adam=True, **kw)
        assert [h["loss"] for h in res.history] == [h["loss"] for h in unbounded.history]
        for (_, a), (_, b) in zip(tree_paths(res.params), tree_paths(unbounded.params)):
            assert torch.equal(a, b)


def test_state_store_matches_reference(tmp_path):
    """The same puts and gets on both stores: the same keys, eviction and
    spill counts, and the reloaded trees value-exact."""
    rng = np.random.default_rng(0)
    trees = {c: {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
                 "b": {"c": rng.normal(0, 1, (5,)).astype(np.float32)}} for c in range(4)}
    for spill in (True, False):
        js = JStore(max_entries=2, spill_dir=str(tmp_path / f"j{spill}") if spill else None)
        ts = ClientStateStore(max_entries=2,
                              spill_dir=str(tmp_path / f"t{spill}") if spill else None)
        ops = [("put", "moon", 0), ("put", "ef", 0), ("put", "moon", 1), ("get", "moon", 0),
               ("put", "ef", 2), ("get", "ef", 0), ("get", "moon", 1), ("put", "moon", 3),
               ("get", "ef", 2), ("get", "moon", 9)]
        for op, kind, cid in ops:
            if op == "put":
                js.put(kind, cid, trees[cid])
                ts.put(kind, cid, bridge.from_numpy_tree(trees[cid]))
                continue
            a, b = js.get(kind, cid), ts.get(kind, cid)
            assert (a is None) == (b is None), (spill, op, kind, cid)
            if a is not None:
                for (_, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
                    assert np.array_equal(np.asarray(x), y.numpy())
            assert ts.keys() == js.keys() and len(ts) == len(js)
            assert ts.stats() == js.stats()
        ts.pop("moon", 1)
        js.pop("moon", 1)
        assert ts.keys() == js.keys() and ("moon", 1) not in ts
    with pytest.raises(ValueError):
        ClientStateStore(max_entries=-1)


def test_compression_needs_client_ids(resnet):
    from repro_torch.core import compress
    from repro_torch.fl.batched import make_engine
    from repro_torch.optim.adam import AdamConfig
    params = bridge.from_numpy_tree(resnet["init"])
    part = resnet["tadapter"].partition(params)
    for name in ("sequential", "vmap"):
        engine = make_engine(
            name, trainer=tfl.LocalTrainer(adapter=resnet["tadapter"], partition=part,
                                           algo=tfl.AlgoConfig(), adam=AdamConfig()),
            partition=part, algo=tfl.AlgoConfig(), compression=compress.make_config("int8"))
        kw = dict(seeds=[1, 2, 3], weights=[1, 1, 1], epochs=1, batch_size=BATCH)
        spec = tsched.RoundSpec(0, "warmup", 0, -1)
        with pytest.raises(ValueError, match="client_ids"):
            engine.run_round(params, spec, resnet["tclients"], **kw)
        with pytest.raises(ValueError, match="client_ids"):
            engine.run_round(params, spec, resnet["tclients"], client_ids=[0, 1], **kw)
    with pytest.raises(ValueError):
        tfl.FLRunConfig(device="cpu", compression="zip")
