"""The DeepSeek-V2-Lite cell at a small size on the CPU: the plain reference's
leaves and layer groups are the port's partition, a whole run comes out
correct, and a run with the timed path broken underneath (half of every
batch left out, a later round's splice lost) comes out not correct."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from perfbench.cell import prepare, run_cell
from perfbench.compare import load_limits
from perfbench.manifest import load_module

ROOT = Path(__file__).resolve().parent.parent
CELL = "deepseek-v2-lite.fedpart"
SMALL = dict(hidden_size=32, num_attention_heads=2, num_key_value_heads=2, kv_lora_rank=16,
             qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, intermediate_size=48,
             moe_intermediate_size=16, n_routed_experts=4, router_experts=8,
             num_experts_per_tok=3, num_layers=3, vocab_size=97, seq_len=12)
TRAFFIC = dict(clients=2, samples_per_client=6, batch_size=2, local_epochs=1, eval_samples=4,
               rounds_per_call=2)


def test_leaves_and_groups_are_the_ports_partition():
    from repro_torch.tree import path_str, tree_paths

    inp = prepare(ROOT, CELL, 5, "cpu", config_override=SMALL, traffic_override=TRAFFIC)
    adapter = inp.cell.program().make_task(inp.cell.config)
    port = adapter.init(torch.Generator().manual_seed(0))
    assert {path_str(p): tuple(t.shape) for p, t in tree_paths(port)} == \
        {lf.path: lf.shape for lf in inp.leaves}
    part = adapter.partition(port)
    assert part.num_groups == inp.groups == 5
    assert {lf.path: lf.group for lf in inp.leaves} == dict(part.assignment)


def test_the_full_size_leaves_count_535m_parameters_in_7_groups():
    cfg = json.loads((ROOT / "perfbench/configs/deepseek-v2-lite/config.json").read_text())
    ref = load_module(ROOT / "perfbench/configs/deepseek-v2-lite/reference.py", "ref_dsv2")
    leaves = ref.leaves(cfg)
    assert sum(lf.numel for lf in leaves) == cfg["params"] == 535_060_992
    assert ref.num_groups(cfg) == cfg["layer_groups"] == 7
    assert max(lf.group for lf in leaves) == 6


def test_a_sound_run_is_correct():
    result = run_cell(ROOT, CELL, 2**31 + 77, 0.05, False, device="cpu",
                      config_override=SMALL, traffic_override=TRAFFIC, log=lambda msg: None)
    assert result["correct"] is True
    limits = load_limits(ROOT, CELL)
    for name, check in result["checks"].items():
        assert check["value"] <= limits[name] / 10 or name in ("unmoved", "stuck")
    assert result["checks"]["unmoved"]["value"] == result["checks"]["stuck"]["value"] == 0
    assert result["attempted"] == 2


def _half_batch(monkeypatch):
    from repro_torch.fl.client import LocalTrainer
    orig = LocalTrainer._total_loss

    def half(self, params, inputs, labels, global_params, prev_params):
        n = inputs.shape[0] // 2
        return orig(self, params, inputs[:n], labels[:n], global_params, prev_params)

    monkeypatch.setattr(LocalTrainer, "_total_loss", half)


def _later_splice_lost(monkeypatch):
    from repro_torch.fl.batched import VmapEngine
    orig = VmapEngine.run_round

    def lost(self, params, spec, *args, **kwargs):
        new, losses, locals_ = orig(self, params, spec, *args, **kwargs)
        return (params if spec.index == 2 else new), losses, locals_

    monkeypatch.setattr(VmapEngine, "run_round", lost)


@pytest.mark.parametrize("fault", [_half_batch, _later_splice_lost])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = run_cell(ROOT, CELL, 2**31 + 99, 0.05, False, device="cpu",
                      config_override=SMALL, traffic_override={**TRAFFIC, "rounds_per_call": 1},
                      log=lambda msg: None)
    assert result["correct"] is False
    assert [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
