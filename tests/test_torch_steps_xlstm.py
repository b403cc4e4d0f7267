"""The port's training half of ``launch/steps.py`` and ``models/api.py``
``loss`` against the reference on bridged ``xlstm-125m`` smoke params (f32:
one (mLSTM, sLSTM) pair stacked under ``pairs``, the sLSTM's loop over
time differentiated step by step) and one numpy batch (the cases live in
``torch_steps_cases.py``):

* ``api.loss`` (``impl="plain"``) and its gradients against the
  reference's ``api.loss`` (``impl="xla"``); ``remat=True`` bit-identical
  to ``remat=False``; ``impl="kernel"`` refuses to be differentiated;
* ``list_groups`` equal to the reference's;
* the FNU step (``accum`` 1 and 2) and the partial step on ``pairs/0``,
  ``embed`` and ``final_norm|head``: per-step loss and updated params and
  Adam moments against the reference's jitted steps, every leaf outside
  the group bit-identical to its input, the input params never written,
  the partial optimizer state the reference's size.

Tolerances: loss and gradients ≤1e-5; two steps ≤1e-5 at ``adam_eps=1e-3``
and lr 1e-3, the repo's cross-form regime (Adam amplifies f32 rounding);
exact where nothing is computed.
"""

import pytest

from tests.torch_steps_cases import *  # noqa: F401,F403  (the shared cases)
from tests.torch_steps_cases import make_setup

ARCH = "xlstm-125m"
# smoke: one pair; full size has 6
GROUPS = [("embed", None), ("pairs", 0), ("final_norm|head", None)]


@pytest.fixture(scope="module")
def setup():
    return make_setup(ARCH)


@pytest.fixture
def expected_groups():
    return GROUPS


@pytest.fixture(params=GROUPS, ids=lambda g: f"{g[0]}-{g[1]}")
def group_kind(request):
    return request.param
