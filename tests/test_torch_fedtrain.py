"""The port's ``launch/fedtrain.py`` against the reference's.

* ``FedPartMeshTrainer`` on bridged ``tinyllama-1.1b`` smoke params and
  the same numpy batches as the reference's trainer: the warm-up FNU round
  and one round per group (``n_groups + 1``, as ``tests/test_fedtrain.py``),
  two steps each; per-round loss and the final params;
* ``transmitted_params`` equal to the reference's for FNU and every group;
  the groups tile the model exactly once;
* ``main([... "--device", "cpu"])`` runs the mesh-trainer mode and the
  ``--sim-clients`` mode; ``--engine shard_map`` raises naming its ROADMAP
  item; the parser has every flag of the reference's with its default,
  nargs, type and choices, plus ``--device``;
* ``run_simulation``: the comm / comp books, per round and in total, equal
  to those of the reference's ``run_simulation`` with the same arguments
  (numpy-seeded data and schedule), on the vmap engine with the fused
  masked-Adam step (its plain version here).

Tolerances: the trainer ≤1e-5 at ``adam_eps=1e-3`` and lr 1e-3 (the
repo's cross-form regime); counts and books exact.
"""

import jax
import numpy as np
import pytest
import torch

import repro.fl
from repro.configs import get_config as j_get_config
from repro.core import costs as jcosts
from repro.core.partition import group_param_counts as j_group_param_counts
from repro.core.schedule import RoundSpec as JRoundSpec
from repro.launch import fedtrain as jfedtrain
from repro.models import api as japi
from repro.optim.adam import AdamConfig as JAdamConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import costs
from repro_torch.core.partition import group_param_counts
from repro_torch.core.schedule import FULL_NETWORK, FedPartSchedule, RoundSpec
from repro_torch.launch import fedtrain
from repro_torch.optim.adam import AdamConfig
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-5
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_get_config(ARCH, smoke=True)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0), jcfg))
    return jcfg, get_config(ARCH, smoke=True), jparams


def test_trainer_matches_reference_rounds(smoke):
    jcfg, cfg, jparams = smoke
    jtrainer = jfedtrain.FedPartMeshTrainer(jcfg, JAdamConfig(lr=1e-3, eps=1e-3))
    trainer = fedtrain.FedPartMeshTrainer(cfg, AdamConfig(lr=1e-3, eps=1e-3))
    params = bridge.from_numpy_tree(jparams)
    n = len(trainer.groups(params))
    assert n == len(jtrainer.groups(jparams)) == 4
    rng = np.random.default_rng(3)
    jp = jparams
    rounds = FedPartSchedule(num_groups=n, warmup_rounds=1, rounds_per_layer=1,
                             cycles=1).rounds()[: n + 1]
    for spec in rounds:
        batches = [{k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
                    for k in ("tokens", "labels")} for _ in range(2)]
        jspec = JRoundSpec(spec.index, spec.phase, spec.cycle, spec.group)
        jp, jl = jtrainer.run_round(jp, jspec, batches)
        params, loss = trainer.run_round(params, spec,
                                         [bridge.from_numpy_tree(b) for b in batches])
        assert abs(loss - jl) <= TOL, spec
    for (path, a), (_, b) in zip(tree_paths(jax.tree.map(np.asarray, jp)),
                                 tree_paths(bridge.to_numpy_tree(params))):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg="/".join(path))


def test_transmitted_params_match_reference(smoke):
    jcfg, cfg, jparams = smoke
    jtrainer = jfedtrain.FedPartMeshTrainer(jcfg)
    trainer = fedtrain.FedPartMeshTrainer(cfg)
    params = bridge.from_numpy_tree(jparams)
    total = sum(x.numel() for x in tree_leaves(params))
    specs = [RoundSpec(0, "warmup", -1, FULL_NETWORK)] + [
        RoundSpec(i + 1, "partial", 0, i) for i in range(len(trainer.groups(params)))]
    counts = []
    for spec in specs:
        jspec = JRoundSpec(spec.index, spec.phase, spec.cycle, spec.group)
        counts.append(trainer.transmitted_params(params, spec))
        assert counts[-1] == jtrainer.transmitted_params(jparams, jspec), spec
    assert counts[0] == total == sum(counts[1:])


def test_main_runs_both_modes(capsys):
    assert fedtrain.main(["--rounds", "3", "--steps-per-round", "1", "--batch", "2",
                          "--seq", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[fedtrain] round") == 3 and "of FNU" in out
    assert fedtrain.main(["--sim-clients", "2", "--rounds", "2", "--batch", "64",
                          "--device", "cpu"]) == 0
    assert "[fedtrain.sim] engine=sequential" in capsys.readouterr().out
    # the shard_map engine on a one-rank client mesh: exits 0, books
    # printed, and the vmap engine's result within 1e-5
    assert fedtrain.main(["--sim-clients", "2", "--rounds", "2", "--batch", "64",
                          "--engine", "shard_map", "--sim-devices", "1",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[fedtrain.sim] engine=shard_map" in out and "of FNU" in out
    res = {e: fedtrain.run_simulation(fedtrain.parse_args(
        ["--sim-clients", "2", "--rounds", "2", "--batch", "64", "--engine", e,
         "--sim-devices", "1", "--device", "cpu"])) for e in ("shard_map", "vmap")}
    for a, b in zip(tree_leaves(res["shard_map"].params), tree_leaves(res["vmap"].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([h["loss"] for h in res["shard_map"].history],
                               [h["loss"] for h in res["vmap"].history],
                               rtol=1e-5, atol=1e-5)
    assert res["shard_map"].comm_total_bytes == res["vmap"].comm_total_bytes


def _capture(monkeypatch, module):
    """Wrap ``module.run_federated`` to keep its rounds and result."""
    seen = {}
    real = module.run_federated

    def wrapper(adapter, clients, eval_set, rounds, cfg, **kw):
        seen["rounds"] = list(rounds)
        seen["result"] = real(adapter, clients, eval_set, rounds, cfg, **kw)
        return seen["result"]

    monkeypatch.setattr(module, "run_federated", wrapper)
    return seen


def test_simulation_books_match_reference(monkeypatch):
    argv = ["--sim-clients", "3", "--rounds", "3", "--batch", "64", "--warmup", "1"]
    ref = _capture(monkeypatch, repro.fl)
    assert jfedtrain.main(argv) == 0
    res = fedtrain.run_simulation(fedtrain.parse_args(
        argv + ["--engine", "vmap", "--fused-adam", "--device", "cpu"]))
    jres = ref["result"]
    assert [(r.index, r.phase, r.group) for r in ref["rounds"]] == \
        [(h["round"], h["phase"], h["group"]) for h in res.history]
    assert res.comm_total_bytes == jres.comm_total_bytes
    assert res.comm_fnu_bytes == jres.comm_fnu_bytes
    assert res.comp_total_flops == jres.comp_total_flops
    assert res.comp_fnu_flops == jres.comp_fnu_flops
    rounds = [RoundSpec(r.index, r.phase, r.cycle, r.group) for r in ref["rounds"]]
    jparams = jax.tree.map(np.asarray, jres.params)
    np.testing.assert_array_equal(
        costs.comm_cost(res.params, res.partition, rounds).per_round_bytes,
        jcosts.comm_cost(jparams, jres.partition, ref["rounds"]).per_round_bytes)
    w = group_param_counts(res.params, res.partition).astype(np.float64)
    jw = j_group_param_counts(jparams, jres.partition).astype(np.float64)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(
        costs.comp_cost(res.partition, rounds, group_fwd_flops=w).per_round_flops,
        jcosts.comp_cost(jres.partition, ref["rounds"], group_fwd_flops=jw).per_round_flops)
    assert all(np.isfinite(h["loss"]) for h in res.history)


def _parser_of(main, monkeypatch):
    """The ``ArgumentParser`` that ``main`` builds, caught at ``parse_args``."""
    import argparse

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught) as exc:
        main([])
    monkeypatch.undo()
    return {a.dest: (a.default, a.nargs, a.type, tuple(a.choices or ()))
            for a in exc.value.args[0]._actions if a.dest != "help"}


def test_command_line_has_every_reference_flag(monkeypatch):
    ref = _parser_of(jfedtrain.main, monkeypatch)
    port = _parser_of(fedtrain.main, monkeypatch)
    assert port.pop("device") == ("cuda", None, None, ())
    assert port == ref
