"""The port's async runtime against the JAX package's on the vmap engine,
fused (one cohort masked-Adam launch per bucket and local step; on the CPU
its plain version) and unfused: the reference configurations of
``test_torch_async.py`` (FedBuff with staleness, dropout and two cohorts in
flight; MOON; int8), same setup.  Timelines equal event for event, the
cohorts' slots included (one slot: the one CPU device here, the one JAX
device there); params and merge losses ≤1e-5; cost books exact.
"""

import pytest

from tests.test_torch_async import CONFIGS, assert_runs_match, run_pair, setup  # noqa: F401

TOL = 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_async_matches_reference_vmap(setup, name, fused):  # noqa: F811
    rounds, kw, avail = CONFIGS[name]
    ref, out = run_pair(setup, rounds, engine="vmap", fused=fused, avail=avail, **kw)
    assert_runs_match(ref, out, TOL)
    if kw.get("max_inflight_cohorts", 1) > 1:
        # a pool of one slot: a cohort is on it or queued past exhaustion
        assert {e["submesh"] for e in out.timeline.of_kind("dispatch")} <= {0, -1}
