"""The paper's second task, the nlp transformer classifier, through the
port's FL loop against the JAX package's, end to end (FedAvg;
``test_torch_fl_nlp_fedprox.py`` and ``test_torch_fl_nlp_moon.py`` run the
same comparison for the other two algorithms).

Same federation on both sides: ``nlp-transformer`` at its smoke size (2
blocks, d 64, vocab 512: 4 layer groups), 3 ragged iid clients of
synthetic AG-News-like text (``make_text_dataset``, 4 classes, 32 tokens;
36 / 56 / 40 samples: 2, 3 and 2 steps per epoch at batch 16), the
reference's initial parameters bridged over numpy, FedPart (one warm-up
round, then each group once) and its matched FNU baseline.  The host-side
draws are the reference's, so both sides train on identical batches.

* sequential engine, fused and unfused, against the reference's
  ``run_federated`` (its sequential engine): per-round loss and final
  params ≤1e-4 (``test_torch_fl.py``'s bar);
* vmap engine, fused and unfused, against the reference's ``VmapEngine``
  and against the port's sequential engine: ≤1e-5
  (``test_torch_fl_vmap.py``'s bar).

All at ``adam_eps=1e-3`` (Adam's linear regime, the reference's own
cross-form regime); cost books and schedules exact; accuracy within one
eval sample.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import FedPartSchedule, matched_fnu
from repro.data import (TextDatasetSpec, balanced_eval_set, build_clients,
                        make_text_dataset)
from repro.fl import AlgoConfig, FLRunConfig, nlp_task, run_federated
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.core import schedule as tsched
from repro_torch.data import pipeline as tpipe
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = {"sequential": 1e-4, "vmap": 1e-5}
SIZES = (36, 56, 40)
BATCH = 16
SEQ = 32
FEDPART = FedPartSchedule(num_groups=4, warmup_rounds=1, rounds_per_layer=1, cycles=1)
SCHEDULES = {"fedpart": FEDPART.rounds(), "fnu": matched_fnu(FEDPART).rounds(),
             "mixed": FEDPART.rounds()[:2]}     # the FNU warm-up, then group 0


def make_setup(sizes=SIZES):
    spec = TextDatasetSpec(num_classes=4, vocab_size=512, seq_len=SEQ)
    x, y = make_text_dataset(spec, sum(sizes), seed=0)
    xe, ye = make_text_dataset(spec, 96, seed=7)
    bounds = np.cumsum((0,) + tuple(sizes))
    parts = [np.arange(bounds[i], bounds[i + 1]) for i in range(len(sizes))]
    adapter = nlp_task(num_classes=4, smoke=True)
    return {"adapter": adapter, "clients": build_clients(x, y, parts),
            "tclients": tpipe.build_clients(x, y, parts),
            "eval": balanced_eval_set(xe, ye, per_class=8),
            "init": jax.tree.map(np.asarray, adapter.init(jax.random.key(0))),
            "tadapter": tfl.nlp_task(num_classes=4, smoke=True)}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def assert_runs_close(a_params, a_hist, b, tol, n_eval):
    """``b`` (a port result) against reference params / history ``a``."""
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
        assert abs(x["acc"] - y["acc"]) <= 1.0 / n_eval + 1e-9


def assert_books_equal(ref, out):
    assert out.comm_total_bytes == ref.comm_total_bytes
    assert out.comm_fnu_bytes == ref.comm_fnu_bytes
    assert out.comp_total_flops == ref.comp_total_flops
    assert out.comp_fnu_flops == ref.comp_fnu_flops
    assert dict(out.partition.assignment) == dict(ref.partition.assignment)


def run_both(setup, rounds, engine, *, port_engines=None, **kw):
    """The reference's run on ``engine`` and the port's on each of
    ``port_engines`` (default: the same engine), from the same initial
    parameters."""
    kw = dict(local_epochs=1, batch_size=BATCH, lr=2e-3, adam_eps=1e-3, **kw)
    algo = kw.pop("algo", "fedavg")
    ref = run_federated(setup["adapter"], setup["clients"], setup["eval"], rounds,
                        FLRunConfig(algo=AlgoConfig(name=algo), engine=engine, **kw),
                        init_key=jax.random.key(0))
    trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
    out = {}
    for name in port_engines or (engine,):
        cfg = tfl.FLRunConfig(algo=tfl.AlgoConfig(name=algo), engine=name,
                              device="cpu", **kw)
        out[name] = tfl.run_federated(setup["tadapter"], setup["tclients"],
                                      setup["eval"], trounds, cfg,
                                      init_params=bridge.from_numpy_tree(setup["init"]))
    return ref, out


def check_sequential(setup, algo, fused, schedule):
    """The port's sequential engine against the reference's run."""
    ref, out = run_both(setup, SCHEDULES[schedule], "sequential", algo=algo,
                        fused_adam=fused)
    n_eval = len(setup["eval"][1])
    assert_runs_close(ref.params, ref.history, out["sequential"], TOL["sequential"],
                      n_eval)
    assert_books_equal(ref, out["sequential"])


def check_vmap(setup, algo, fused, schedule):
    """The port's vmap engine against the reference's ``VmapEngine`` and
    against the port's sequential engine."""
    ref, out = run_both(setup, SCHEDULES[schedule], "vmap", algo=algo,
                        fused_adam=fused, port_engines=("vmap", "sequential"))
    n_eval = len(setup["eval"][1])
    assert_runs_close(ref.params, ref.history, out["vmap"], TOL["vmap"], n_eval)
    seq = out["sequential"]
    assert_runs_close(bridge.to_numpy_tree(seq.params), seq.history, out["vmap"],
                      TOL["vmap"], n_eval)
    for res in out.values():
        assert_books_equal(ref, res)


@pytest.mark.parametrize("schedule", ["fedpart", "fnu"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fedavg_run_matches_reference(setup, fused, schedule):
    check_sequential(setup, "fedavg", fused, schedule)


@pytest.mark.parametrize("schedule", ["fedpart", "fnu"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fedavg_vmap_matches_reference(setup, fused, schedule):
    check_vmap(setup, "fedavg", fused, schedule)


def test_tokens_stay_integer(setup):
    """Tokens reach the model as integers: ``stack_client_batches``, the
    vmap engine's batches gathered on the device, and the eval tensors;
    the stacked batches equal the reference's."""
    from repro.data.pipeline import stack_client_batches as j_stack
    ref = j_stack(setup["clients"], BATCH, 1, [1, 2, 3])
    out = tpipe.stack_client_batches(setup["tclients"], BATCH, 1, [1, 2, 3])
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        assert b.inputs.dtype == np.int32 and np.array_equal(b.inputs, a.inputs)
        assert np.array_equal(b.labels, a.labels)
    from repro_torch.fl.batched import VmapEngine
    from repro_torch.fl.client import LocalTrainer
    from repro_torch.optim.adam import AdamConfig
    params = bridge.from_numpy_tree(setup["init"])
    part = setup["tadapter"].partition(params)
    engine = VmapEngine(trainer=LocalTrainer(adapter=setup["tadapter"], partition=part,
                                             algo=tfl.AlgoConfig(), adam=AdamConfig()),
                        partition=part, algo=tfl.AlgoConfig())
    for _, xs, ys, _, _ in engine._buckets(params, setup["tclients"], batch_size=BATCH,
                                           epochs=1, seeds=[1, 2, 3], prev_params=None,
                                           use_prev=False):
        assert xs.dtype == torch.int32 and xs.shape[-1] == SEQ
        assert ys.dtype == torch.int64
    assert torch.as_tensor(setup["eval"][0]).dtype == torch.int32
