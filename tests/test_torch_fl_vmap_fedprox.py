"""FedProx through the port's vmap engine against its sequential engine and
the JAX package's ``VmapEngine``, fused and unfused, on the mixed schedule
(one FNU warm-up round, then partial group 0).  Setup and tolerances
(params and per-round loss ≤1e-5 at ``adam_eps=1e-3``, exact cost books,
accuracy within one eval sample) are ``test_torch_fl_vmap.py``'s.
"""

import pytest

from tests.test_torch_fl_vmap import MIXED, check_engines, setup  # noqa: F401


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fedprox_vmap_matches_sequential_and_reference(setup, fused):  # noqa: F811
    check_engines(setup, "fedprox", fused, MIXED)
