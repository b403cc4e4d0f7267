"""The program's ``fl.*`` ranges and the readers that put device and idle
time down to them: the round loop opens every range, nested, on both
engines; the span helpers on a hand-built trace (the launch link by stream
order, device time through it, idle time outside a label, each of the six
readers); and the trace and the accepted readers unchanged by reading
them."""

from __future__ import annotations

import copy
import dataclasses
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
SMOKE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
             vocab_size=97, max_position_embeddings=16, seq_len=16)
TRAFFIC = dict(clients=3, samples_per_client=40, batch_size=16, local_epochs=1, eval_samples=32)
READERS = {"batches.host_ms_per_round": "FL_BATCHES", "grad.device_ms_per_round": "FL_GRAD",
           "optimizer.device_ms_per_round": "FL_OPTIMIZER",
           "aggregate.device_ms_per_round": "FL_AGGREGATE",
           "eval.device_ms_per_round": "FL_EVAL",
           "round_loop.idle_ms_per_round": "FL_LOCAL_STEP"}
ACCEPTED = ["device_idle_pct", "mfu_pct", "masked_adam.roofline_pct",
            "masked_adam.launches_per_round", "engine.launches_per_round"]


def _program_labels() -> dict[str, str]:
    from repro_torch.fl import batched, client, server
    return {"FL_ROUND": server.FL_ROUND, "FL_EVAL": server.FL_EVAL,
            "FL_BATCHES": client.FL_BATCHES, "FL_LOCAL_STEP": client.FL_LOCAL_STEP,
            "FL_GRAD": client.FL_GRAD, "FL_OPTIMIZER": client.FL_OPTIMIZER,
            "FL_AGGREGATE": batched.FL_AGGREGATE}


def _inputs(**traffic):
    return prepare(ROOT, "nlp.fedpart", 2**31 + 41, "cpu", config_override=SMOKE,
                   traffic_override=dict(TRAFFIC, **traffic))


def _within(inner, outer) -> bool:
    return all(any(s <= a and b <= t for s, t in outer) for a, b in inner)


@pytest.mark.parametrize("engine", ["vmap", "sequential"])
@pytest.mark.parametrize("fused", [True, False])
def test_the_round_loop_opens_every_span_nested(engine, fused):
    inp = _inputs(engine=engine, fused_adam=fused)
    fed = system.Federation(inp.cell.program(), inp.cell.config, inp.traffic, inp.clients,
                            inp.eval_set, inp.fl_seed, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_LABEL):
            fed.call(fedref.nest(inp.params0), inp.checked)
    tr = Trace.from_profile(prof)
    got = {name: spans.spans(tr, label) for name, label in _program_labels().items()}
    rounds, clients = len(inp.checked), inp.traffic.clients
    steps = rounds * inp.traffic.steps_per_client * (1 if engine == "vmap" else clients)
    assert len(got["FL_ROUND"]) == rounds and len(got["FL_EVAL"]) == rounds
    assert len(got["FL_LOCAL_STEP"]) == len(got["FL_GRAD"]) == len(got["FL_OPTIMIZER"]) == steps
    assert len(got["FL_BATCHES"]) == rounds * (1 if engine == "vmap" else clients)
    assert len(got["FL_AGGREGATE"]) == rounds
    assert _within(got["FL_GRAD"], got["FL_LOCAL_STEP"])
    assert _within(got["FL_OPTIMIZER"], got["FL_LOCAL_STEP"])
    for name in ("FL_LOCAL_STEP", "FL_BATCHES", "FL_AGGREGATE", "FL_EVAL"):
        assert _within(got[name], got["FL_ROUND"]), name
    # no two phases of a round overlap: a launch belongs to one of them
    phases = sorted(iv for n in ("FL_BATCHES", "FL_LOCAL_STEP", "FL_AGGREGATE", "FL_EVAL")
                    for iv in got[n])
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_reads_the_program_s_label(metric):
    assert reader(ROOT, metric).LABEL == _program_labels()[READERS[metric]]


def _trace(calls: bool = True) -> Trace:
    """Two rounds in a 10,000-ns window.  A kernel launched before the
    window runs into it; round one: a batch copy, a local step whose
    backward the autograd thread (2) launches inside ``fl.grad`` and whose
    optimizer kernel runs after its range closed, an aggregate and an eval;
    round two: one step.  Without ``calls``, the host made no launch call."""
    host = {1: [(-200, -190, "cudaLaunchKernel"),
                (0, 10_000, WINDOW_LABEL), (0, 10_000, CALL_LABEL),
                (100, 4_900, "fl.round"), (200, 600, "fl.batches"),
                (300, 350, "cudaMemcpyAsync"),
                (1_000, 2_000, "fl.local_step"), (1_000, 1_500, "fl.grad"),
                (1_100, 1_110, "cudaLaunchKernel"), (1_500, 1_900, "fl.optimizer"),
                (1_600, 1_610, "cudaLaunchKernel"), (3_000, 3_200, "fl.aggregate"),
                (3_050, 3_060, "cudaLaunchKernel"), (4_000, 4_500, "fl.eval"),
                (4_100, 4_110, "cudaLaunchKernelExC"), (4_600, 4_610, "cudaStreamSynchronize"),
                (5_100, 9_900, "fl.round"), (6_000, 7_000, "fl.local_step"),
                (6_000, 6_500, "fl.grad"), (6_050, 6_060, "cuLaunchKernel")],
            2: [(1_300, 1_310, "cudaLaunchKernel")]}
    if not calls:
        host = {t: [op for op in ops if not op[2].startswith("cu")] for t, ops in host.items()}
    device = [(0, 50, "kernel", "before_the_window"), (400, 700, "gpu_memcpy", "Memcpy HtoD"),
              (1_200, 1_400, "kernel", "gemm"), (1_400, 1_800, "kernel", "gemm_backward"),
              (2_100, 2_500, "kernel", "masked_adam_cohort_kernel"),
              (3_100, 3_300, "kernel", "reduce"), (4_200, 4_400, "kernel", "eval_gemm"),
              (6_100, 6_900, "kernel", "gemm")]
    return Trace((0, 10_000), device, host)


def test_each_activity_pairs_with_its_launch_call_in_stream_order():
    assert spans.launched_by(_trace()) == [None, (1, 300), (1, 1_100), (2, 1_300), (1, 1_600),
                                           (1, 3_050), (1, 4_100), (1, 6_050)]
    assert spans.launched_by(_trace(calls=False)) == [None] * 8


def test_device_time_follows_the_launch_into_its_span():
    tr = _trace()
    # the backward launched from thread 2, and the optimizer kernel run after
    # its range closed, count under the range their launch started in
    assert spans.device_seconds(tr, "fl.grad") == pytest.approx(1_400e-9)
    assert spans.device_seconds(tr, "fl.optimizer") == pytest.approx(400e-9)
    assert spans.device_seconds(tr, "fl.local_step") == pytest.approx(1_800e-9)
    assert spans.device_seconds(tr, "fl.batches") == pytest.approx(300e-9)
    assert spans.device_seconds(tr, "fl.round") == pytest.approx(2_500e-9)
    assert tr.busy_s == pytest.approx(2_550e-9)
    assert spans.host_seconds(tr, "fl.round") == pytest.approx(9_600e-9)
    assert spans.device_seconds(tr, "fl.nothing") is None
    assert spans.device_seconds(_trace(calls=False), "fl.grad") is None


def test_idle_outside_a_label_by_gap_middle():
    # gaps 50-400, 700-1200, 1800-2100 (middle 1950, inside a local step),
    # 2500-3100, 3300-4200, 4400-6100, 6900-10000
    tr = _trace()
    assert spans.idle_seconds_outside(tr, "fl.local_step") == pytest.approx(7_150e-9)
    assert spans.idle_seconds_outside(tr, "fl.batches") == pytest.approx(7_100e-9)
    assert spans.idle_seconds_outside(tr, "fl.round") == 0.0
    assert spans.idle_seconds_outside(tr, "fl.nothing") is None


def _run(tr: Trace) -> Run:
    inp = _inputs()
    return Run(cell=inp.cell, traffic=inp.traffic, leaves=inp.leaves, num_groups=inp.groups,
               setup_s=1.0, window_s=10e-6, rounds=[(2, 2), (3, 3)], window_peak_bytes=0,
               launches=4, trace=tr, peaks=peaks_for("NVIDIA H100 80GB HBM3"))


@pytest.mark.parametrize("metric,ms", [
    ("batches.host_ms_per_round", 400e-6 / 2), ("grad.device_ms_per_round", 1_400e-6 / 2),
    ("optimizer.device_ms_per_round", 400e-6 / 2),
    ("aggregate.device_ms_per_round", 200e-6 / 2), ("eval.device_ms_per_round", 200e-6 / 2),
    ("round_loop.idle_ms_per_round", 7_150e-6 / 2)])
def test_each_reader_on_the_hand_built_trace(metric, ms):
    read = reader(ROOT, metric).read
    assert read(_run(_trace())) == pytest.approx(ms)
    assert read(dataclasses.replace(_run(_trace()), trace=None)) is None
    # a program without the labels: nothing to read, nothing raised
    bare = _trace()
    bare.host = {t: [op for op in ops if not op[2].startswith("fl.")]
                 for t, ops in bare.host.items()}
    assert read(_run(bare)) is None


def test_reading_the_spans_leaves_the_trace_and_the_accepted_readers_as_they_were():
    tr = _trace()
    before = copy.deepcopy(tr)
    want = {m: reader(ROOT, m).read(_run(before)) for m in ACCEPTED}
    for metric in READERS:
        reader(ROOT, metric).read(_run(tr))
    spans.launched_by(tr)
    assert tr == before
    for metric in ACCEPTED:
        got = reader(ROOT, metric).read(_run(tr))
        assert got is not None and got == want[metric], metric
