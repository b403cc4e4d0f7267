"""The port's training half of ``launch/steps.py`` and ``models/api.py``
``loss`` against the reference on bridged ``tinyllama-1.1b`` smoke params
(f32) and one numpy batch (the cases live in ``torch_steps_cases.py``):

* ``api.loss`` (``impl="plain"``) and its gradients against the
  reference's ``api.loss`` (``impl="xla"``); ``remat=True`` bit-identical
  to ``remat=False``; ``impl="kernel"`` refuses to be differentiated;
* ``list_groups`` equal to the reference's;
* the FNU step (``accum`` 1 and 2) and the partial step of every group
  kind: per-step loss and updated params and Adam moments against the
  reference's jitted steps, every leaf outside the group bit-identical to
  its input, the input params never written, the partial optimizer state
  the reference's size.
* the partial step's backward is pruned: counted by the profiler, the
  layers after the group get no weight-gradient GEMMs and the layers before
  it no backward GEMMs at all.

Tolerances: loss and gradients ≤1e-5; two steps ≤1e-5 at ``adam_eps=1e-3``
and lr 1e-3, the repo's cross-form regime (Adam amplifies f32 rounding);
exact where nothing is computed.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.tree import tree_leaves
from tests.torch_steps_cases import *  # noqa: F401,F403  (the shared cases)
from tests.torch_steps_cases import make_setup

ARCH = "tinyllama-1.1b"
GROUPS = [("embed", None), ("blocks", 0), ("blocks", 1), ("final_norm|head", None)]


@pytest.fixture(scope="module")
def setup():
    return make_setup(ARCH)


@pytest.fixture
def expected_groups():
    return GROUPS


@pytest.fixture(params=GROUPS, ids=lambda g: f"{g[0]}-{g[1]}")
def group_kind(request):
    return request.param


GEMMS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def _gemms(fn) -> int:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key in GEMMS)


def test_partial_step_prunes_the_backward():
    """TinyLlama smoke at 6 layers, the partial step on ``blocks/2``: the
    backward runs the head's input-gradient GEMM, activation-gradient GEMMs
    only for blocks 3-5, the full backward for block 2, nothing for blocks
    0-1 — the FNU step's per-block count, less the weight GEMMs."""
    cfg = get_config(ARCH, smoke=True).with_(num_layers=6)
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, cfg, "cpu")
    batch = api.synth_batch(gen, cfg, api.InputShape("t", 32, 2, "train"), "cpu")
    with torch.no_grad():
        fwd = _gemms(lambda: api.loss(params, cfg, batch))
    fnu = steps.make_train_step(cfg, remat=False)
    fnu_bwd = _gemms(lambda: fnu(params, steps.init_opt_state(params), batch)) - fwd
    group = steps.StackedGroup("blocks", 2)
    part = steps.make_fedpart_train_step(cfg, group, remat=False)
    part_bwd = _gemms(lambda: part(params, steps.init_partial_opt_state(params, group),
                                   batch)) - fwd
    weights = sum(1 for x in tree_leaves(params["blocks"]) if x.dim() == 3)   # 7
    head = 2                                   # dW and dX of the untied head
    per_block, rest = divmod(fnu_bwd - head, cfg.num_layers)
    assert rest == 0 and per_block > weights
    after = cfg.num_layers - group.index - 1
    assert part_bwd == 1 + after * (per_block - weights) + per_block
