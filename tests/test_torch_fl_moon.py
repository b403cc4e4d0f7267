"""MOON through the port's fused FL loop against the JAX package's
fused run: FedPart (one warm-up round, then each group once) and the
matched FNU baseline on ResNet-4.  Setup and tolerances (per-round loss and
final params ≤1e-4 at ``adam_eps=1e-3``, exact cost books, accuracy within
one eval sample) are ``test_torch_fl.py``'s.
"""

import pytest

from tests.test_torch_fl import check_run_matches_reference, setup  # noqa: F401


@pytest.mark.parametrize("schedule", ["fedpart", "fnu"])
def test_moon_fused_run_matches_reference(setup, schedule):  # noqa: F811
    check_run_matches_reference(setup, "moon", True, schedule)
