"""The port's training half of ``launch/steps.py`` and ``models/api.py``
``loss`` against the reference on bridged ``deepseek-v3-671b`` smoke params
with its MTP head (``with_(mtp_depth=1)`` in both packages; f32: MLA in
every block, one dense block under ``blocks``, one MoE block under
``moe_blocks``, sigmoid top-2 of 4 experts plus a shared expert, the
``mtp`` head of ``proj``, ``norm`` and a dense block) and one numpy batch
(the cases live in ``torch_steps_cases.py``):

* ``api.loss`` (``impl="plain"``), the MoE aux loss and ``MTP_WEIGHT`` ×
  the MTP head's loss included, and its gradients against the reference's
  ``api.loss`` (``impl="xla"``); ``remat=True`` bit-identical to
  ``remat=False``; MLA has no kernel, so ``impl="kernel"`` is the plain
  loss, bit for bit;
* ``list_groups`` equal to the reference's, the ``mtp`` group included;
* the FNU step (``accum`` 1 and 2) and the partial step on ``embed``,
  ``blocks/0``, ``moe_blocks/0``, ``mtp`` and ``final_norm|head``:
  per-step loss and updated params and Adam moments against the
  reference's jitted steps, every leaf outside the group bit-identical to
  its input, the input params never written, the partial optimizer state
  the reference's size;
* ``FedPartMeshTrainer``: an FNU round and a partial round of ``mtp``
  against the reference's trainer (losses, transmitted parameters, final
  params).

Tolerances: loss and gradients ≤1e-5; steps and rounds ≤1e-5 at
``adam_eps=1e-3`` and lr 1e-3, the repo's cross-form regime; exact where
nothing is computed.
"""

import pytest
import torch

from repro_torch import bridge
from repro_torch.models import api
from repro_torch.tree import tree_leaves
from tests.torch_steps_cases import check_mesh_trainer_rounds, make_setup
# the shared cases, all but test_kernel_impl_refuses_grad (no kernel on MLA's path)
from tests.torch_steps_cases import test_fnu_step_matches_reference  # noqa: F401
from tests.torch_steps_cases import test_list_groups_match_reference  # noqa: F401
from tests.torch_steps_cases import test_loss_and_grads_match_reference  # noqa: F401
from tests.torch_steps_cases import test_partial_step_matches_reference  # noqa: F401
from tests.torch_steps_cases import test_remat_is_bit_identical  # noqa: F401

ARCH = "deepseek-v3-671b"
GROUPS = [("embed", None), ("blocks", 0), ("moe_blocks", 0), ("mtp", None),
          ("final_norm|head", None)]


@pytest.fixture(scope="module")
def setup():
    return make_setup(ARCH, mtp_depth=1)


@pytest.fixture
def expected_groups():
    return GROUPS


@pytest.fixture(params=GROUPS, ids=lambda g: f"{g[0]}-{g[1]}")
def group_kind(request):
    return request.param


def test_kernel_impl_is_the_plain_loss(setup):
    """No kernel is on MLA's path (the reference has none), so the kernel
    impl differentiates as the plain one does."""
    _, _, cfg, jparams, batch = setup
    out = {}
    for impl in ("plain", "kernel"):
        params = bridge.from_numpy_tree(jparams)
        leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
        loss = api.loss(params, cfg, bridge.from_numpy_tree(batch), impl=impl)
        out[impl] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out["plain"][0], out["kernel"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["plain"][1], out["kernel"][1]))


def test_mesh_trainer_rounds_match_reference(setup):
    check_mesh_trainer_rounds(setup, GROUPS.index(("mtp", None)))
