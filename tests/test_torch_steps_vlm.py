"""The port's training half of ``launch/steps.py`` and ``models/api.py``
``loss`` against the reference on bridged ``llava-next-34b`` smoke params
(f32: two dense GQA blocks under ``blocks``, an untied head) and one numpy
batch of stub media embeddings ahead of the tokens, with labels on the
text positions only (the cases live in ``torch_steps_cases.py``):

* ``api.loss`` (``impl="plain"``, the media positions' logits dropped) and
  its gradients against the reference's ``api.loss``; ``remat=True``
  bit-identical to ``remat=False``; ``impl="kernel"`` refuses to be
  differentiated (the flash kernel);
* ``list_groups`` equal to the reference's;
* the FNU step (``accum`` 1 and 2, the media split with the tokens) and
  the partial step on ``embed``, ``blocks/0``, ``blocks/1`` and
  ``final_norm|head``: per-step loss and updated params and Adam moments
  against the reference's jitted steps, every leaf outside the group
  bit-identical to its input, the input params never written, the partial
  optimizer state the reference's size;
* ``FedPartMeshTrainer``: an FNU round and a partial round of ``blocks/0``
  against the reference's trainer (losses, transmitted parameters, final
  params).

Tolerances: loss and gradients ≤1e-5; steps and rounds ≤1e-5 at
``adam_eps=1e-3`` and lr 1e-3, the repo's cross-form regime; exact where
nothing is computed.
"""

import pytest

from tests.torch_steps_cases import *  # noqa: F401,F403  (the shared cases)
from tests.torch_steps_cases import check_mesh_trainer_rounds, make_setup

ARCH = "llava-next-34b"
# smoke: two layers; full size has 60
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


def test_mesh_trainer_rounds_match_reference(setup):
    check_mesh_trainer_rounds(setup, GROUPS.index(("blocks", 0)))
