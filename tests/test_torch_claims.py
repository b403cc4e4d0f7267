"""The port's claims experiment (``repro_torch.experiments.claims_experiment``)
against the reference's ``experiments/claims_experiment.py``.

* ``build()`` at its defaults makes the reference script's data, eval set,
  client shards, schedules and run config bit for bit (numpy-seeded on
  both sides).
* The cost books of the full run (25 FedPart rounds, their matched 25 FNU
  rounds) equal the reference's ``core.costs`` books exactly: they are
  analytic, so no training runs.  ``CLAIMS_COMM_RATIO`` and
  ``CLAIMS_COMP_RATIO`` are the values ``chip_smoke.py`` asserts on the card.
* A 4-round prefix of both runs (3 warm-up FNU rounds, then group 0 for
  FedPart) from the reference's initial parameters, at 1 local epoch and
  ``adam_eps=1e-3``, against the reference's ``run_federated``: accuracies
  and every recorded step size within 1e-4, the summary's spikes too.
* ``main(argv)`` runs end to end on the CPU at a small size and writes the
  reference's keys.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core.costs import comm_cost, comp_cost
from repro.core.partition import group_param_counts
from repro.core.schedule import FedPartSchedule, matched_fnu
from repro.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                        iid_partition, make_vision_dataset)
from repro.fl import FLRunConfig, resnet_task, run_federated
from repro_torch import bridge
from repro_torch.core import costs as tcosts
from repro_torch.core.partition import group_param_counts as tgroup_param_counts
from repro_torch.core.schedule import matched_fnu as tmatched_fnu
from repro_torch.experiments import claims_experiment as ce
from repro_torch.fl import run_federated as trun_federated

torch.set_num_threads(1)

TOL = 1e-4
PREFIX_ROUNDS = 4
PREFIX_EPOCHS = 1
# the full run's books as fractions of FNU's (the reference's, pinned here and
# asserted by chip_smoke.py's claims phase)
CLAIMS_COMM_RATIO = 0.28
CLAIMS_COMP_RATIO = 0.6859794101279911
REF_KEYS = {"local_epochs", "rounds", "fedpart", "fnu", "elapsed_s"}


def _reference():
    """The reference script's objects, from its constants (the argparse
    defaults at experiments/claims_experiment.py:28-33 and the calls at
    :37-48)."""
    spec = VisionDatasetSpec(num_classes=16, image_size=16, noise=1.2)     # :37-38
    x, y = make_vision_dataset(spec, 800, seed=0)                          # :39
    xe, ye = make_vision_dataset(spec, 800 // 2, seed=99)                  # :40
    eval_set = balanced_eval_set(xe, ye, per_class=16)                     # :41
    clients = build_clients(x, y, iid_partition(len(y), 4, seed=0))        # :42
    adapter = resnet_task("resnet8", num_classes=16)                       # :43
    sched = FedPartSchedule(num_groups=10, warmup_rounds=3, rounds_per_layer=1,
                            cycles=2, bridge_rounds=2)                     # :45-46
    cfg = FLRunConfig(local_epochs=8, batch_size=32, lr=1e-3,
                      track_stepsizes=True)                                # :47-48
    return adapter, clients, eval_set, sched, cfg


@pytest.fixture(scope="module")
def ref():
    return _reference()


def _rounds(rounds):
    return [(r.index, r.phase, r.cycle, r.group) for r in rounds]


def test_build_matches_reference_script(ref):
    adapter, clients, eval_set, sched, cfg = ref
    tadapter, tclients, teval, tsched, tcfg = ce.build(device="cpu")
    assert len(tclients) == len(clients) == 4
    for a, b in zip(clients, tclients):
        assert np.array_equal(a.inputs, b.inputs) and np.array_equal(a.labels, b.labels)
    for a, b in zip(eval_set, teval):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert _rounds(tsched.rounds()) == _rounds(sched.rounds())
    assert _rounds(tmatched_fnu(tsched).rounds()) == _rounds(matched_fnu(sched).rounds())
    assert tsched.total_rounds == sched.total_rounds == 25
    for field in ("local_epochs", "batch_size", "lr", "adam_eps", "track_stepsizes",
                  "engine", "seed", "eval_every", "eval_batch", "sample_fraction"):
        assert getattr(tcfg, field) == getattr(cfg, field), field
    assert (tcfg.device, tcfg.fused_adam) == ("cpu", False)
    assert ce.build(fused_adam=True, device="cpu")[4].fused_adam


def test_books_of_the_full_run_match_reference(ref):
    """25 FedPart rounds and the matched 25 FNU rounds: comm and comp books
    equal the reference's to the byte and FLOP, and the pinned ratios."""
    adapter, _, _, sched, _ = ref
    params = adapter.init(jax.random.key(0))
    part = adapter.partition(params)
    weights = group_param_counts(params, part).astype(np.float64)

    tadapter, _, _, tsched, _ = ce.build(device="cpu")
    tparams = bridge.from_numpy_tree(jax.tree.map(np.asarray, params))
    tpart = tadapter.partition(tparams)
    tweights = tgroup_param_counts(tparams, tpart).astype(np.float64)
    assert np.array_equal(weights, tweights)
    for rounds, trounds in ((sched.rounds(), tsched.rounds()),
                            (matched_fnu(sched).rounds(), tmatched_fnu(tsched).rounds())):
        comm, tcomm = comm_cost(params, part, rounds), tcosts.comm_cost(tparams, tpart,
                                                                        trounds)
        comp = comp_cost(part, rounds, group_fwd_flops=weights)
        tcomp = tcosts.comp_cost(tpart, trounds, group_fwd_flops=tweights)
        assert (tcomm.total_bytes, tcomm.fnu_total_bytes) == \
            (comm.total_bytes, comm.fnu_total_bytes)
        assert (float(tcomp.total_flops), float(tcomp.fnu_total_flops)) == \
            (float(comp.total_flops), float(comp.fnu_total_flops))
    fp_comm = tcosts.comm_cost(tparams, tpart, tsched.rounds())
    fp_comp = tcosts.comp_cost(tpart, tsched.rounds(), group_fwd_flops=tweights)
    assert fp_comm.total_bytes / fp_comm.fnu_total_bytes == CLAIMS_COMM_RATIO
    assert float(fp_comp.total_flops) / float(fp_comp.fnu_total_flops) == \
        CLAIMS_COMP_RATIO


def test_prefix_matches_reference_run():
    """Both runs' first 4 rounds from the reference's initial parameters:
    accuracies, step sizes and the summary's spikes within 1e-4."""
    adapter, clients, eval_set, sched, _ = _reference()
    cfg = FLRunConfig(local_epochs=PREFIX_EPOCHS, batch_size=32, lr=1e-3,
                      adam_eps=1e-3, track_stepsizes=True)
    init = jax.tree.map(np.asarray, adapter.init(jax.random.key(0)))
    tadapter, tclients, teval, tsched, tcfg = ce.build(
        epochs=PREFIX_EPOCHS, adam_eps=1e-3, device="cpu")
    runs = {}
    for name, rounds, trounds in (
            ("fedpart", sched.rounds(), tsched.rounds()),
            ("fnu", matched_fnu(sched).rounds(), tmatched_fnu(tsched).rounds())):
        r = run_federated(adapter, clients, eval_set, rounds[:PREFIX_ROUNDS], cfg,
                          init_key=jax.random.key(0))
        t = trun_federated(tadapter, tclients, teval, trounds[:PREFIX_ROUNDS], tcfg,
                           init_params=bridge.from_numpy_tree(init))
        np.testing.assert_allclose([h["acc"] for h in t.history],
                                   [h["acc"] for h in r.history], rtol=0, atol=TOL)
        assert t.tracker.boundaries == r.tracker.boundaries
        # the first client of each round: 200 samples, 6 batches of 32 an epoch
        assert len(t.tracker.sizes) == PREFIX_ROUNDS * 6 * PREFIX_EPOCHS
        np.testing.assert_allclose(t.tracker.sizes, r.tracker.sizes, rtol=TOL, atol=TOL)
        runs[name] = r, t
    ref_out = ce.summarize(runs["fedpart"][0], runs["fnu"][0], sched, cfg, 0.0)
    out = ce.summarize(runs["fedpart"][1], runs["fnu"][1], tsched, tcfg, 0.0)
    for run in ("fedpart", "fnu"):
        for key in ("best_acc", "final_acc", "spike"):
            assert abs(out[run][key] - ref_out[run][key]) <= TOL * (1 + abs(ref_out[run][key]))
        assert np.isfinite(out[run]["spike"])
    assert out["fedpart"]["comm_ratio"] == ref_out["fedpart"]["comm_ratio"]
    assert out["fedpart"]["comp_ratio"] == ref_out["fedpart"]["comp_ratio"]


def test_main_runs_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "claims.json"
    out = ce.main(["--device", "cpu", "--epochs", "1", "--samples", "256",
                   "--classes", "4", "--cycles", "0", "--out", str(path)])
    written = json.loads(path.read_text())
    assert set(written) == set(out) == REF_KEYS
    assert set(written["fedpart"]) == {"best_acc", "final_acc", "comm_ratio",
                                       "comp_ratio", "spike", "acc_curve"}
    assert set(written["fnu"]) == {"best_acc", "final_acc", "spike", "acc_curve"}
    assert written["rounds"] == len(written["fedpart"]["acc_curve"]) == 3
    assert written["fedpart"]["comm_ratio"] == 1.0      # warm-up only: all FNU
    assert all(0.0 <= a <= 1.0 for a in written["fnu"]["acc_curve"])
    assert '"comm_ratio"' in capsys.readouterr().out
