"""The program's ``fl.grad.pruned`` range and ``grad.pruned_steps_pct``,
which reads it: the fused cohort step (the vmap engine's, ``fused_adam``)
opens one inside each ``fl.grad`` of a partial round, and no other round
or step form opens one; the reader reads its program's labels, and on a
hand-built trace the share of ``fl.grad`` ranges that hold a pruned one,
0 where none opened and ``None`` without a trace."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch
from torch.profiler import record_function

from perfbench import fedref, spans, system
from perfbench.cell import Run, prepare
from perfbench.manifest import reader
from perfbench.peaks import peaks_for
from perfbench.tracing import CALL_LABEL, WINDOW_LABEL, Trace

ROOT = Path(__file__).resolve().parent.parent
METRIC = "grad.pruned_steps_pct"
SMOKE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
             vocab_size=97, max_position_embeddings=16, seq_len=16)
TRAFFIC = dict(clients=3, samples_per_client=40, batch_size=16, local_epochs=1, eval_samples=32)


def _inputs(cell, **traffic):
    return prepare(ROOT, cell, 2**31 + 41, "cpu", config_override=SMOKE,
                   traffic_override=dict(TRAFFIC, **traffic))


def test_the_reader_reads_the_program_s_labels():
    from repro_torch.optim import partial
    mod = reader(ROOT, METRIC)
    assert (mod.LABEL, mod.STEP_LABEL) == (partial.FL_GRAD_PRUNED, partial.FL_GRAD)


@pytest.mark.parametrize("cell", ["nlp.fedpart", "nlp.fnu"])
@pytest.mark.parametrize("engine", ["vmap", "sequential"])
@pytest.mark.parametrize("fused", [True, False])
def test_a_pruned_range_opens_inside_each_grad_of_a_fused_partial_round(cell, engine,
                                                                       fused):
    inp = _inputs(cell, engine=engine, fused_adam=fused)
    fed = system.Federation(inp.cell.program(), inp.cell.config, inp.traffic, inp.clients,
                            inp.eval_set, inp.fl_seed, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_LABEL):
            fed.call(fedref.nest(inp.params0), inp.checked)
    tr = Trace.from_profile(prof)
    grads, pruned = spans.spans(tr, "fl.grad"), spans.spans(tr, "fl.grad.pruned")
    engaged = engine == "vmap" and fused and inp.traffic.rounds == "partial"
    assert grads and len(pruned) == (len(grads) if engaged else 0)
    # one inside each: every pruned range lies in a gradient range, and no
    # gradient range holds two
    assert all(sum(s <= a and b <= t for a, b in pruned) == (1 if engaged else 0)
               for s, t in grads)
    want = 100.0 if engaged else 0.0
    assert reader(ROOT, METRIC).read(_run(tr)) == want


def _trace(pruned: int) -> Trace:
    """Three local steps in a 10,000-ns window, the first ``pruned`` of whose
    ``fl.grad`` ranges hold an ``fl.grad.pruned`` range; the autograd thread
    (2) opens no range."""
    host = {1: [(0, 10_000, WINDOW_LABEL), (0, 10_000, CALL_LABEL)],
            2: [(1_300, 1_310, "cudaLaunchKernel")]}
    for i in range(3):
        s = 1_000 + 3_000 * i
        host[1] += [(s, s + 2_000, "fl.local_step"), (s, s + 1_500, "fl.grad"),
                    (s + 1_500, s + 1_900, "fl.optimizer")]
        if i < pruned:
            host[1].append((s + 10, s + 1_490, "fl.grad.pruned"))
    device = [(1_400, 1_800, "kernel", "gemm")]
    return Trace((0, 10_000), device, host)


def _run(tr: Trace | None) -> Run:
    inp = _inputs("nlp.fedpart")
    return Run(cell=inp.cell, traffic=inp.traffic, leaves=inp.leaves, num_groups=inp.groups,
               setup_s=1.0, window_s=10e-6, rounds=[(2, 2), (3, 3)], window_peak_bytes=0,
               launches=4, trace=tr, peaks=peaks_for("NVIDIA H100 80GB HBM3"))


@pytest.mark.parametrize("pruned,pct", [(3, 100.0), (2, 200.0 / 3), (0, 0.0)])
def test_the_reader_on_a_hand_built_trace(pruned, pct):
    read = reader(ROOT, METRIC).read
    assert read(_run(_trace(pruned))) == pytest.approx(pct)
    assert read(_run(None)) is None
    # no gradient range to count against: nothing to read, nothing raised
    bare = _trace(pruned)
    bare.host = {t: [op for op in ops if not op[2].startswith("fl.")]
                 for t, ops in bare.host.items()}
    assert read(_run(bare)) is None
