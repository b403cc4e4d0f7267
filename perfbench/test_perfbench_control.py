"""The control on the card: the plain reference computed with TF32 on, the
precision just below the configurations' float32 with TF32 off, put in the
program's place, fails the cell's limits; the program does not.  At the
configurations' full widths and the cells' clients, with fewer samples
each and one local epoch (two local steps a round), so a test run holds
it.  TF32
exists only on the card, so this skips elsewhere."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from perfbench.compare import load_limits, verdict
from perfbench.control import readings

ROOT = Path(__file__).resolve().parent.parent
TRAFFIC = dict(samples_per_client=128, local_epochs=1, eval_samples=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["nlp.fnu", "resnet18.fedpart"])
def test_tf32_control_fails_and_the_program_passes(card, cell):
    got = readings(ROOT, cell, 3_000_000_019, ("program", "tf32"), card,
                   traffic_override=TRAFFIC)
    limits = load_limits(ROOT, cell)
    assert verdict(got["program"], limits), got["program"]
    assert not verdict(got["tf32"], limits), got["tf32"]
