"""Heterogeneous per-client layer plans through both of the port's engines,
against the JAX package's ``VmapEngine`` and ``SequentialEngine``.

Mirrors the ``test_hetero_plan_*`` and fused-plan block of
``tests/test_engine_equivalence.py``: capacity tiers (0.34, 0.67, 1.0)
give ResNet-4's 6 groups nested prefixes of 3 / 5 / 6; the schedule is an
FNU warm-up round and a partial round on group 4, which tier 0 clamps to
its deepest group (2), so both rounds are genuinely mixed cohorts (group 5
trained by one tier on the FNU round; groups 0, 1, 3, 5 by nobody on the
partial round, so they keep the global).  ``random`` plans draw seeded
per-(round, client) subsets.  The sequential engines train each client's
pruned group set (fused: its block mask); the vmap engines run the
FNU-shaped step with each client's bitmask (fused: the cohort kernel's
group mask).

Tolerances: the reference's for plans, ``adam_eps=1e-2`` (the two engines
are different float programs, pruned vs masked) and ≤1e-5 on params and
per-round losses; cost books and schedules exact.
"""

import jax
import numpy as np
import pytest

from repro.core.schedule import RoundSpec
from repro.fl import AlgoConfig, FLRunConfig, run_federated
from repro_torch import bridge
from tests.test_torch_fl_vmap import (MIXED, _assert_runs_close, check_engines,  # noqa: F401
                                      make_setup, setup)

TIERS = (0.34, 0.67, 1.0)
HETERO = dict(capacity_tiers=TIERS, adam_eps=1e-2)
HETERO_MIXED = [MIXED[0], RoundSpec(index=1, phase="partial", cycle=0, group=4)]


@pytest.mark.parametrize("kind", ["nested", "random"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_plan_engines_match_reference(setup, kind, fused):  # noqa: F811
    """Port vmap == reference vmap == port sequential; and the port's
    sequential engine == the reference's sequential engine."""
    out = check_engines(setup, "fedavg", fused, HETERO_MIXED, plan=kind, **HETERO)
    ref_seq = run_federated(
        setup["adapter"], setup["clients"], setup["eval"], HETERO_MIXED,
        FLRunConfig(local_epochs=1, batch_size=16, lr=2e-3, fused_adam=fused,
                    plan=kind, **HETERO), init_key=jax.random.key(0))
    _assert_runs_close(ref_seq.params, ref_seq.history, out["sequential"], 1e-5)


def test_plan_ragged_buckets():
    """A client below the batch size routes through its own bucket while its
    plan row rides along (the partial round, nested plans, fused)."""
    check_engines(make_setup((12, 36, 20)), "fedavg", True, HETERO_MIXED[1:],
                  plan="nested", **HETERO)


def test_homogeneous_plan_is_the_default_path(setup):  # noqa: F811
    """A plan kind whose every row is the round's mask collapses to the
    homogeneous path: the same numbers as no plan, bit for bit."""
    from repro_torch import fl as tfl
    from repro_torch.core import schedule as tsched
    rounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in MIXED]
    for engine in ("sequential", "vmap"):
        runs = [tfl.run_federated(
            setup["tadapter"], setup["tclients"], setup["eval"], rounds,
            tfl.FLRunConfig(local_epochs=1, batch_size=16, engine=engine, device="cpu",
                            fused_adam=True, **kw),
            init_params=bridge.from_numpy_tree(setup["init"]))
            for kw in ({}, dict(plan="nested", capacity_tiers=(1.0,)))]
        for a, b in zip(jax.tree.leaves(bridge.to_numpy_tree(runs[0].params)),
                        jax.tree.leaves(bridge.to_numpy_tree(runs[1].params))):
            np.testing.assert_array_equal(a, b)
