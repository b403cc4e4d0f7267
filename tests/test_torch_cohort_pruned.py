"""The fused cohort step's pruned gradient (``LocalTrainer.run_cohort_round``,
``fused=True``) against its whole-buffer gradient, on the CPU.

On a homogeneous partial round (a group, no per-client plan) the step
differentiates the round's group alone; a plan round in which every client
trains that same group takes the whole-buffer gradient and feeds the
masked-Adam kernel the same group mask, so the two must train alike.  For
ResNet-4 (BatchNorm moments spliced every step) and the nlp transformer at
its smoke size, at the first group, a middle one and the head: the same
stacked parameters, BN moments and losses to 1e-6 relative, over a bucket
whose clients have padded steps (``step_valid`` 0), with fewer matrix
products and convolution backwards (the profiler's op counts).  The pruned
round opens one ``fl.grad.pruned`` range inside each ``fl.grad``; a plan
round and an FNU round open none.
"""

import numpy as np
import pytest
import torch

from repro_torch import fl as tfl
from repro_torch.data.synthetic import (TextDatasetSpec, VisionDatasetSpec,
                                        make_text_dataset, make_vision_dataset)
from repro_torch.optim.adam import AdamConfig
from repro_torch.optim.partial import FL_GRAD, FL_GRAD_PRUNED
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

CLIENTS, STEPS, BATCH = 3, 3, 8
# client 1 pads its last step, client 2 its last two
STEP_VALID = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], dtype=np.int32)
TASKS = {
    "resnet4": (lambda: tfl.resnet_task("resnet4", num_classes=4),
                lambda n: make_vision_dataset(VisionDatasetSpec(num_classes=4,
                                                                image_size=8), n, seed=3)),
    "nlp": (lambda: tfl.nlp_task(num_classes=4, smoke=True),
            lambda n: make_text_dataset(TextDatasetSpec(num_classes=4, vocab_size=512,
                                                        seq_len=16), n, seed=3)),
}
PRODUCTS = ("aten::mm", "aten::bmm", "aten::convolution_backward")


def _setup(task):
    make_adapter, make_data = TASKS[task]
    adapter = make_adapter()
    params = adapter.init(torch.Generator().manual_seed(0))
    part = adapter.partition(params)
    trainer = tfl.LocalTrainer(adapter=adapter, partition=part, algo=tfl.AlgoConfig(),
                               adam=AdamConfig(lr=1e-2))
    x, y = make_data(CLIENTS * STEPS * BATCH)
    xs = torch.as_tensor(x).reshape(CLIENTS, STEPS, BATCH, *x.shape[1:])
    ys = torch.as_tensor(y.astype(np.int64)).reshape(CLIENTS, STEPS, BATCH)
    return trainer, params, xs, ys


def _round(trainer, params, xs, ys, group, plan_rows=None):
    """One fused cohort round; returns (stacked params, losses, counts of the
    two ranges and of the products)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stacked, losses = trainer.run_cohort_round(params, xs, ys, STEP_VALID,
                                                   group=group, plan_rows=plan_rows,
                                                   fused=True)
    counts = {e.key: e.count for e in prof.key_averages()}
    return stacked, losses, {FL_GRAD: counts.get(FL_GRAD, 0),
                             FL_GRAD_PRUNED: counts.get(FL_GRAD_PRUNED, 0),
                             "products": sum(counts.get(k, 0) for k in PRODUCTS)}


def _assert_close(got, want):
    """Equal to 1e-6 of the reference's norm, leaf by leaf."""
    want, got = want.detach().double(), got.detach().double()
    assert torch.linalg.vector_norm(got - want) <= \
        1e-6 * torch.linalg.vector_norm(want) + 1e-30


@pytest.mark.parametrize("which", ["first", "middle", "head"])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_pruned_gradient_trains_as_the_whole_buffer_gradient(task, which):
    trainer, params, xs, ys = _setup(task)
    groups = trainer.partition.num_groups
    group = {"first": 0, "middle": groups // 2, "head": groups - 1}[which]
    got, got_losses, got_ranges = _round(trainer, params, xs, ys, group)
    plan = np.zeros((CLIENTS, groups), dtype=bool)
    plan[:, group] = True
    want, want_losses, want_ranges = _round(trainer, params, xs, ys, group, plan)
    assert got_ranges.pop("products") < want_ranges.pop("products")
    assert got_ranges == {FL_GRAD: STEPS, FL_GRAD_PRUNED: STEPS}
    assert want_ranges == {FL_GRAD: STEPS, FL_GRAD_PRUNED: 0}
    _assert_close(got_losses, want_losses)
    got_items, want_items = tree_paths(got), tree_paths(want)
    assert [p for p, _ in got_items] == [p for p, _ in want_items]
    moved = 0
    for (path, a), (_, b) in zip(got_items, want_items):
        _assert_close(a, b)
        moved += not torch.equal(b, b[:1].expand_as(b))
    assert moved > 0     # the round trained something, differently per client


@pytest.mark.parametrize("task", sorted(TASKS))
def test_an_fnu_round_takes_the_whole_buffer_gradient(task):
    trainer, params, xs, ys = _setup(task)
    _, losses, ranges = _round(trainer, params, xs, ys, -1)
    ranges.pop("products")
    assert ranges == {FL_GRAD: STEPS, FL_GRAD_PRUNED: 0}
    assert torch.isfinite(losses).all()
