"""FedProx on the nlp transformer task through the port's FL loop against the
JAX package's: FedPart and its matched FNU baseline on the sequential
engine, fused and unfused, against the reference's ``run_federated``; and
the vmap engine, fused and unfused, on the mixed schedule (the FNU warm-up
round, then group 0) against the reference's ``VmapEngine`` and the port's
sequential engine.  Setup and tolerances are ``test_torch_fl_nlp.py``'s.
"""

import pytest

from tests.test_torch_fl_nlp import check_sequential, check_vmap, setup  # noqa: F401


@pytest.mark.parametrize("schedule", ["fedpart", "fnu"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fedprox_run_matches_reference(setup, fused, schedule):  # noqa: F811
    check_sequential(setup, "fedprox", fused, schedule)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fedprox_vmap_matches_reference(setup, fused):  # noqa: F811
    check_vmap(setup, "fedprox", fused, "mixed")
