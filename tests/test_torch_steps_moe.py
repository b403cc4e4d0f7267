"""The port's training half of ``launch/steps.py`` and ``models/api.py``
``loss`` against the reference on bridged ``llama4-maverick-400b-a17b``
smoke params (f32: two MoE blocks stacked under ``moe_blocks``, top-1 of 4
experts plus a shared expert, the load-balance aux loss in the loss) and
one numpy batch (the cases live in ``torch_steps_cases.py``):

* ``api.loss`` (``impl="plain"``) and its gradients, the router's through
  the gate values and the aux loss, against the reference's ``api.loss``
  (``impl="xla"``); ``remat=True`` bit-identical to ``remat=False``;
  ``impl="kernel"`` refuses to be differentiated (the flash kernel);
* ``list_groups`` equal to the reference's;
* the FNU step (``accum`` 1 and 2) and the partial step on ``embed``,
  ``moe_blocks/0``, ``moe_blocks/1`` and ``final_norm|head``: per-step
  loss and updated params and Adam moments against the reference's jitted
  steps, every leaf outside the group bit-identical to its input, the
  input params never written, the partial optimizer state the reference's
  size;
* ``FedPartMeshTrainer``: an FNU round and a partial round of
  ``moe_blocks/0`` against the reference's trainer (losses, transmitted
  parameters, final params).

Tolerances: loss and gradients ≤1e-5; steps and rounds ≤1e-5 at
``adam_eps=1e-3`` and lr 1e-3, the repo's cross-form regime; exact where
nothing is computed.
"""

import pytest

from tests.torch_steps_cases import *  # noqa: F401,F403  (the shared cases)
from tests.torch_steps_cases import check_mesh_trainer_rounds, make_setup

ARCH = "llama4-maverick-400b-a17b"
# smoke: two MoE layers (every Llama-4 layer is MoE); full size has 48
GROUPS = [("embed", None), ("moe_blocks", 0), ("moe_blocks", 1), ("final_norm|head", None)]


@pytest.fixture(scope="module")
def setup():
    return make_setup(ARCH)


@pytest.fixture
def expected_groups():
    return GROUPS


@pytest.fixture(params=GROUPS, ids=lambda g: f"{g[0]}-{g[1]}")
def group_kind(request):
    return request.param


def test_mesh_trainer_rounds_match_reference(setup):
    check_mesh_trainer_rounds(setup, GROUPS.index(("moe_blocks", 0)))
