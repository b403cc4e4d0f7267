"""The port's training half of ``launch/steps.py`` and ``models/api.py``
``loss`` against the reference on bridged ``whisper-small`` smoke params
(f32: two encoder blocks under ``enc_blocks``, two decoder blocks with
cross-attention under ``dec_blocks``, learned ``enc_pos`` / ``dec_pos``,
LayerNorm, GELU MLPs with biases, the tied embedding) and one numpy batch
of tokens, labels and stub frames (the cases live in
``torch_steps_cases.py``):

* ``api.loss`` (``impl="plain"``) and its gradients, the frame positions'
  and the cross-attention's included, against the reference's
  ``api.loss``; ``remat=True`` bit-identical to ``remat=False``;
  ``impl="kernel"`` refuses to be differentiated (the flash kernel);
* ``list_groups`` equal to the reference's: ``embed``, the encoder and
  decoder blocks, and the tail group ``final_norm|enc_norm|enc_pos|dec_pos``;
* the FNU step (``accum`` 1 and 2, the frames split with the tokens) and
  the partial step on ``embed``, ``enc_blocks/0``, ``dec_blocks/1`` and
  the tail group: per-step loss and updated params and Adam moments
  against the reference's jitted steps, every leaf outside the group
  bit-identical to its input, the input params never written, the partial
  optimizer state the reference's size;
* ``FedPartMeshTrainer``: an FNU round and a partial round of
  ``dec_blocks/0`` against the reference's trainer (losses, transmitted
  parameters, final params).

Tolerances: loss and gradients ≤1e-5; steps and rounds ≤1e-5 at
``adam_eps=1e-3`` and lr 1e-3, the repo's cross-form regime; exact where
nothing is computed.
"""

import pytest

from tests.torch_steps_cases import *  # noqa: F401,F403  (the shared cases)
from tests.torch_steps_cases import check_mesh_trainer_rounds, make_setup

ARCH = "whisper-small"
TAIL = ("final_norm|enc_norm|enc_pos|dec_pos", None)
# smoke: two encoder and two decoder blocks; full size has 12 of each
ALL_GROUPS = ([("embed", None), ("enc_blocks", 0), ("enc_blocks", 1), ("dec_blocks", 0),
               ("dec_blocks", 1), TAIL])
GROUPS = [("embed", None), ("enc_blocks", 0), ("dec_blocks", 1), TAIL]


@pytest.fixture(scope="module")
def setup():
    return make_setup(ARCH)


@pytest.fixture
def expected_groups():
    return ALL_GROUPS


@pytest.fixture(params=GROUPS, ids=lambda g: f"{g[0]}-{g[1]}")
def group_kind(request):
    return request.param


def test_mesh_trainer_rounds_match_reference(setup):
    check_mesh_trainer_rounds(setup, ALL_GROUPS.index(("dec_blocks", 0)))
