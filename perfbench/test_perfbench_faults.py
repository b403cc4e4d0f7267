"""A whole run with the timed path broken underneath comes out not correct:
one run per fault a training cell can have on one card (the exchange
between cards does not exist there), and a later round's lost splice.  The
look for a card is skipped; the rest of the run is the benchmark's own."""

from __future__ import annotations

from pathlib import Path

import pytest

from perfbench.cell import run_cell

ROOT = Path(__file__).resolve().parent.parent
SMOKE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
             vocab_size=97, max_position_embeddings=16, seq_len=16)
RESNET = dict(stages=[1, 1], channels=[8, 16], num_classes=10, image_size=8)
TRAFFIC = dict(clients=3, samples_per_client=40, batch_size=16, local_epochs=1, eval_samples=32)


def _state_unchanged(monkeypatch):
    """Every local step returns its state unchanged: the optimizer launch
    does nothing."""
    from repro_torch.kernels.masked_adam import MaskedAdamCohort
    monkeypatch.setattr(MaskedAdamCohort, "step", lambda self, t, g: None)


def _half_batch(monkeypatch):
    """Half of every batch left out, the loss the mean over the rest."""
    from repro_torch.fl.client import LocalTrainer
    orig = LocalTrainer._total_loss

    def half(self, params, inputs, labels, global_params, prev_params):
        n = inputs.shape[0] // 2
        return orig(self, params, inputs[:n], labels[:n], global_params, prev_params)

    monkeypatch.setattr(LocalTrainer, "_total_loss", half)


def _later_splice_lost(monkeypatch):
    """The second round's aggregate is never spliced into the global
    weights: the round loop goes on from the weights it started with."""
    from repro_torch.fl.batched import VmapEngine
    orig = VmapEngine.run_round

    def lost(self, params, spec, *args, **kwargs):
        new, losses, locals_ = orig(self, params, spec, *args, **kwargs)
        return (params if spec.index == 1 else new), losses, locals_

    monkeypatch.setattr(VmapEngine, "run_round", lost)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _later_splice_lost])
@pytest.mark.parametrize("cell,config", [("nlp.fedpart", SMOKE), ("resnet18.fnu", RESNET)])
def test_a_broken_step_is_not_correct(monkeypatch, fault, cell, config):
    fault(monkeypatch)
    result = run_cell(ROOT, cell, 2**31 + 99, 0.05, False, device="cpu",
                      config_override=config, traffic_override=TRAFFIC,
                      log=lambda msg: None)
    assert result["correct"] is False
    failed = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert failed, result["checks"]
