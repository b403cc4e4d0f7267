"""The dry run's probe extrapolation (``launch/cost_probes.py``, as the
reference's ``launch/dryrun.py`` uses it) against a full-depth count.

For one config of each kind (decoder, MoE with dense-first layers, hybrid,
xLSTM, encoder-decoder), each cut to a depth past its probes, and each of
train / prefill / decode: the FLOPs that ``fit_and_extrapolate`` gives
from the probe configs' fake-tensor runs (``dryrun.trace_step``) equal the
full-depth run's within 1e-6 relative.  At B 2 x 16, one scan chunk of
the smoke configs: the sLSTM's and the scans' Python loops cost per step
on fake tensors too.  And the xLSTM prefill's extension over the sequence
(``dryrun.seq_points``): traced at two and three chunks and extended to
five, equal to the five-chunk trace in FLOPs, op bytes and activation
peak.  (``tests/test_torch_dryrun.py`` holds the rest of the
dry run against the reference.)
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import cost_probes, dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.api import InputShape

torch.set_num_threads(1)

REL = 1e-6

KINDS = {
    "decoder": ("tinyllama-1.1b", dict(num_layers=5)),
    "moe_dense_first": ("deepseek-v3-671b", dict(num_layers=5, first_dense_layers=2,
                                                 num_experts=8)),
    "hybrid": ("zamba2-7b", dict(num_layers=7)),          # 3 chunks of 2 and a tail
    "xlstm": ("xlstm-125m", dict(num_layers=6)),
    "encdec": ("whisper-small", dict(num_layers=4, encoder_layers=3)),
}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", list(KINDS))
def test_probe_extrapolation_is_exact(name, kind):
    arch, kw = KINDS[name]
    cfg = get_config(arch, smoke=True).with_(**kw)
    shape = InputShape("short", 16, 2, kind)
    mesh = MeshShape((1, 1))
    plan = cost_probes.probe_plan(cfg)
    costs = [dryrun._costs_of(*dryrun.trace_step(pc, shape, mesh, remat=False,
                                                  peak=False))
             for pc in plan.probe_cfgs]
    got = cost_probes.fit_and_extrapolate(plan, costs)["flops"]
    full = dryrun._costs_of(*dryrun.trace_step(cfg, shape, mesh, remat=False,
                                                  peak=False))["flops"]
    assert full > 0
    assert abs(got - full) <= REL * full


def test_xlstm_prefill_sequence_extension_is_exact():
    """An xLSTM prefill traced at two and three scan chunks and extended to
    five (``dryrun.trace_step``) equals the five-chunk trace: FLOPs, op
    bytes and the activation peak.  Train steps and decode are traced at
    their own length."""
    cfg = get_config("xlstm-125m", smoke=True)
    c = cfg.ssm_chunk
    shape = InputShape("long", 5 * c, 2, "prefill")
    assert dryrun.seq_points(cfg, shape) == (2 * c, 3 * c)
    assert dryrun.seq_points(cfg, InputShape("long", 5 * c, 2, "train")) is None
    assert dryrun.seq_points(get_config("tinyllama-1.1b", smoke=True), shape) is None
    got, _ = dryrun.trace_step(cfg, shape, MeshShape((1, 1)))
    want, _ = dryrun._trace_at(cfg, shape, MeshShape((1, 1)))
    assert want.flops > 0 and want.act_peak_bytes > 0
    for a, b in ((got.flops, want.flops), (got.op_bytes, want.op_bytes),
                 (got.act_peak_bytes, want.act_peak_bytes)):
        assert abs(a - b) <= REL * b
