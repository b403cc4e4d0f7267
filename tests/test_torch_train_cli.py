"""The port's ``launch/train.py`` (the paper's end-to-end driver) against
the reference's.

* ``build_task_and_data``: clients, eval set and the partition's group
  count equal to the reference's (vision and text, IID and Dirichlet);
  ``build_schedule``: FedPart (sequential / reverse / random, bridges) and
  FNU rounds equal;
* ``main`` on the CPU at a small size (the nlp smoke task, FedPart, 2
  clients) writes a JSON with the reference's keys whose ``rounds``,
  ``comm_bytes``, ``comm_ratio_to_fnu``, ``comp_flops`` and
  ``comp_ratio_to_fnu`` equal the reference's, and a checkpoint that loads
  back bit-identical to ``result.params``;
* the parser has every flag of the reference's, plus ``--device``.

Tolerance: exact (numpy-seeded data and schedules; integer books).
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.checkpoint import load_checkpoint
from repro_torch.launch import train
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

SMALL = ["--task", "nlp", "--smoke", "--samples", "64", "--clients", "2",
         "--local-epochs", "1", "--warmup", "1", "--rl", "1", "--bridge", "0",
         "--eval-per-class", "4", "--quiet"]
BOOKS = ("rounds", "comm_bytes", "comm_ratio_to_fnu", "comp_flops", "comp_ratio_to_fnu")


@pytest.mark.parametrize("argv", [
    ["--task", "resnet8", "--samples", "300", "--clients", "4"],
    ["--task", "resnet18", "--samples", "200", "--clients", "3", "--alpha", "0.5",
     "--classes", "5", "--image-size", "16"],
    ["--task", "nlp", "--smoke", "--samples", "120", "--clients", "3", "--alpha", "0.3"],
])
def test_datasets_and_partitions_match_reference(argv):
    # the reference's main parses inline; the port's parser has every one of
    # its flags (plus --device), so one namespace serves both
    args = train.parse_args(argv)
    ja, jclients, (jxe, jye) = jtrain.build_task_and_data(args)
    adapter, clients, (xe, ye) = train.build_task_and_data(args)
    assert len(clients) == len(jclients)
    for c, jc in zip(clients, jclients):
        np.testing.assert_array_equal(c.inputs, jc.inputs)
        np.testing.assert_array_equal(c.labels, jc.labels)
    np.testing.assert_array_equal(xe, jxe)
    np.testing.assert_array_equal(ye, jye)
    jgroups = ja.partition(ja.init(jax.random.key(0))).num_groups
    groups = adapter.partition(adapter.init(torch.Generator().manual_seed(0))).num_groups
    assert groups == jgroups


@pytest.mark.parametrize("extra", [
    [], ["--order", "reverse", "--cycles", "2", "--bridge", "3"],
    ["--order", "random", "--cycles", "3", "--seed", "5"],
    ["--strategy", "fnu"], ["--strategy", "fnu", "--rounds", "7"],
])
def test_schedules_match_reference(extra):
    args = train.parse_args(extra)
    for groups in (4, 10):
        ref = jtrain.build_schedule(args, groups)
        port = train.build_schedule(args, groups)
        assert port.total_rounds == ref.total_rounds
        assert [(r.index, r.phase, r.cycle, r.group) for r in port.rounds()] == \
            [(r.index, r.phase, r.cycle, r.group) for r in ref.rounds()]


def test_main_books_json_and_checkpoint(tmp_path):
    jout, out = tmp_path / "ref.json", tmp_path / "port.json"
    assert jtrain.main(SMALL + ["--out", str(jout)]) == 0
    summary, result = train.run(train.parse_args(
        SMALL + ["--out", str(out), "--checkpoint-dir", str(tmp_path / "ckpt"),
                 "--device", "cpu"]))
    ref, port = json.loads(jout.read_text()), json.loads(out.read_text())
    assert sorted(port) == sorted(ref)
    for key in BOOKS:
        assert port[key] == ref[key], key
    assert [h["group"] for h in port["history"]] == [h["group"] for h in ref["history"]]
    assert port["rounds"] == len(port["history"]) == summary["rounds"]

    params, state = load_checkpoint(str(tmp_path / "ckpt"))
    assert state == {"rounds": summary["rounds"], "best_acc": result.best_acc}
    assert [p for p, _ in tree_paths(params)] == [p for p, _ in tree_paths(result.params)]
    for (path, a), (_, b) in zip(tree_paths(params), tree_paths(result.params)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert train.main(SMALL + ["--strategy", "fnu", "--rounds", "1",
                               "--device", "cpu"]) == 0


def test_command_line_has_every_reference_flag(monkeypatch):
    from tests.test_torch_fedtrain import _parser_of
    ref = _parser_of(jtrain.main, monkeypatch)
    port = _parser_of(train.main, monkeypatch)
    assert port.pop("device") == ("cuda", None, None, ())
    assert port == ref
