"""The plain references against the port at smoke size on the CPU: the same
leaves, layer groups and logits, and whole runs of every cell that come out
correct with their numbers far inside the limits."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import fedref
from perfbench.cell import prepare, run_cell
from perfbench.compare import load_limits

ROOT = Path(__file__).resolve().parent.parent
SMOKE = {
    "nlp": dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                vocab_size=97, max_position_embeddings=16, seq_len=16),
    "resnet18": dict(stages=[1, 1], channels=[8, 16], num_classes=10, image_size=8),
}
TRAFFIC = dict(clients=3, samples_per_client=40, batch_size=16, local_epochs=1, eval_samples=32)
CELLS = ["nlp.fedpart", "resnet18.fedpart", "nlp.fnu", "resnet18.fnu"]


def _inputs(cell, seed=3):
    return prepare(ROOT, cell, seed, "cpu", config_override=SMOKE[cell.split(".")[0]],
                   traffic_override=TRAFFIC)


@pytest.mark.parametrize("cell", ["nlp.fnu", "resnet18.fnu"])
def test_leaves_groups_and_logits_match_the_port(cell):
    from repro_torch.tree import path_str, tree_paths

    inp = _inputs(cell)
    adapter = inp.cell.program().make_task(inp.cell.config)
    port = adapter.init(torch.Generator().manual_seed(0))
    port_leaves = {path_str(p): tuple(t.shape) for p, t in tree_paths(port)}
    assert port_leaves == {lf.path: lf.shape for lf in inp.leaves}
    part = adapter.partition(port)
    assert part.num_groups == inp.groups
    assert {lf.path: lf.group for lf in inp.leaves} == dict(part.assignment)

    x, y = inp.clients[0]
    x, y = torch.as_tensor(x[:8]), torch.as_tensor(np.asarray(y[:8], np.int64))
    ref_loss = inp.cell.reference.loss(inp.params0, inp.cell.config, x, y)
    port_loss, _ = adapter.loss_and_stats(fedref.nest(inp.params0), x, y)
    torch.testing.assert_close(ref_loss, port_loss, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = run_cell(ROOT, cell, 2**31 + 77, 0.05, False, device="cpu",
                      config_override=SMOKE[cell.split(".")[0]], traffic_override=TRAFFIC,
                      log=lambda msg: None)
    assert result["correct"] is True
    limits = load_limits(ROOT, cell)
    for name, check in result["checks"].items():
        assert check["limit"] == limits[name]
        assert check["value"] <= limits[name] / 10 or name == "unmoved"
    assert result["checks"]["unmoved"]["value"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"samples_per_s", "peak_mem_gib", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_the_same_seed_gives_the_same_inputs():
    a, b = _inputs("nlp.fedpart", 2**33 + 5), _inputs("nlp.fedpart", 2**33 + 5)
    for (xa, ya), (xb, yb) in zip(a.clients, b.clients):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    for k in a.params0:
        assert torch.equal(a.params0[k], b.params0[k])
    c = _inputs("nlp.fedpart", 2**33 + 6)
    assert not np.array_equal(a.clients[0][0], c.clients[0][0])
