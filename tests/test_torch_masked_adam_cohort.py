"""The vmap engine's kernel side and stacked plumbing, against the JAX
package's, on ResNet-8 parameters made by the reference and bridged over
numpy.

* ``ops.pack_stacked`` / ``unpack_stacked``, ``block_masks_for_plan`` and
  ``plan_block_mask`` equal the reference's exactly;
* the cohort plain version (``masked_adam_cohort_ref``) equals one
  single-client ``masked_adam_ref`` per client bit for bit, padded clients
  and frozen blocks untouched; the cohort wrapper (``MaskedAdamCohort``) on
  a CPU stack takes it, and refuses what the kernel does not take;
* ``stack_client_batches`` and the stacked masking helpers equal the
  reference's exactly; the stacked and plan aggregations are within 1e-6
  (f32 sums in another order);
* the wrapper's C interface (``struct CohortParams``, field for field) and
  the CUDA cohort kernel against the plain version, on a card only
  (``gpu``).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import masking as jmask
from repro.core.aggregation import is_local_stat as j_is_local_stat
from repro.data import build_clients as j_build_clients
from repro.data.pipeline import stack_client_batches as j_stack_client_batches
from repro.fl.tasks import resnet_task
from repro.kernels.masked_adam import ops as jops
from repro_torch import bridge
from repro_torch.core import aggregation as tagg
from repro_torch.core import masking as tmask
from repro_torch.core.aggregation import is_local_stat
from repro_torch.data import pipeline as tpipe
from repro_torch.fl import tasks as ttasks
from repro_torch.kernels import build
from repro_torch.kernels.masked_adam import (MaskedAdamCohort, masked_adam_cohort_ref,
                                             masked_adam_ref, ops)
from repro_torch.kernels.masked_adam import kernel as madam_kernel
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

CLIENTS = 4
AGG_TOL = 1e-6


@pytest.fixture(scope="module")
def resnet8():
    """The reference's ResNet-8 params stacked over ``CLIENTS`` clients (each
    client its own perturbation), numpy and bridged, with both partitions."""
    params = jax.tree.map(np.asarray, resnet_task("resnet8").init(jax.random.key(1)))
    rng = np.random.default_rng(3)
    stacked = jax.tree.map(
        lambda a: np.stack([a + 0.01 * c * rng.standard_normal(a.shape).astype(a.dtype)
                            for c in range(CLIENTS)]), params)
    tparams = bridge.from_numpy_tree(params)
    return {"params": params, "tparams": tparams, "stacked": stacked,
            "tstacked": bridge.from_numpy_tree(stacked),
            "jpart": resnet_task("resnet8").partition(params),
            "tpart": ttasks.resnet_task("resnet8").partition(tparams)}


def _assert_trees_equal(jtree, ttree, tol=0.0):
    ja = tree_paths(jax.tree.map(np.asarray, jtree))
    tb = tree_paths(ttree)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        b = b.detach().numpy()
        if tol:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg="/".join(path))
        else:
            assert np.array_equal(b, a), "/".join(path)


def _plan(rows, groups=10, seed=5):
    p = np.random.default_rng(seed).random((rows, groups)) < 0.4
    p[np.arange(rows), np.arange(rows) % groups] = True      # each trains a group
    return p


# -- layout and masks ---------------------------------------------------------

def test_pack_stacked_identical_on_resnet8(resnet8):
    jp, jmeta = jops.pack_stacked(resnet8["stacked"], 8)
    tp, tmeta = ops.pack_stacked(resnet8["tstacked"], 8)
    assert tp.shape == (CLIENTS, 1576, 128) == jp.shape
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert (tmeta.shapes, tmeta.sizes, tmeta.padded) == \
        (jmeta.shapes, jmeta.sizes, jmeta.padded)
    # each client's rows are the single-tree layout
    single, _ = ops.pack(tmask.unstack_tree(resnet8["tstacked"], CLIENTS)[2], 8)
    assert torch.equal(tp[2], single)
    back = ops.unpack_stacked(tp, tmeta)
    _assert_trees_equal(jops.unpack_stacked(jp, jmeta), back)
    for _, leaf in tree_paths(back):             # views into the packed buffer
        assert leaf.untyped_storage().data_ptr() == tp.untyped_storage().data_ptr()
    with pytest.raises(ValueError):
        ops.pack_stacked({"a": torch.zeros(2, 3), "b": torch.zeros(3, 3)})


def test_plan_block_masks_identical_on_resnet8(resnet8):
    plan = _plan(6)
    for je, te in ((None, None), (j_is_local_stat, is_local_stat)):
        a = jops.block_masks_for_plan(resnet8["params"], resnet8["jpart"], plan, 8,
                                      exclude=je)
        b = ops.block_masks_for_plan(resnet8["tparams"], resnet8["tpart"], plan, 8,
                                     exclude=te)
        assert b.shape == (6, 197) and b.dtype == np.int32 and np.array_equal(a, b)
        gids = ops.block_group_ids(resnet8["tparams"], resnet8["tpart"], 8, exclude=te)
        rows = torch.as_tensor(plan, dtype=torch.float32)
        for c in range(6):
            ref = np.asarray(jops.plan_block_mask(gids, jnp.asarray(plan[c], jnp.float32)))
            got = ops.plan_block_mask(gids, rows[c])
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
            assert np.array_equal(got.numpy(), b[c])
        assert np.array_equal(ops.plan_block_mask(gids, rows).numpy(), b)
        # the kernel's own decision: every step valid, then client 2 padded
        valid = torch.ones(6, dtype=torch.int32)
        gm = torch.as_tensor(plan, dtype=torch.int32)
        got = ops.plan_block_mask(torch.as_tensor(gids), gm, valid)
        assert np.array_equal(got.numpy(), b)
        valid[2] = 0
        want = b.copy()
        want[2] = 0
        assert np.array_equal(ops.plan_block_mask(gids, gm, valid).numpy(), want)
    with pytest.raises(ValueError):
        ops.block_masks_for_plan(resnet8["tparams"], resnet8["tpart"], plan[:, :3])


# -- the cohort step ------------------------------------------------------------

def _cohort_inputs(rows=64, clients=CLIENTS, seed=4):
    rng = np.random.default_rng(seed)
    p, g, m = (torch.tensor(rng.standard_normal((clients, rows, 128)), dtype=torch.float32)
               for _ in range(3))
    v = torch.tensor(np.abs(rng.standard_normal((clients, rows, 128))) * 0.01,
                     dtype=torch.float32)
    return p, g, m * 0.1, v


@pytest.mark.parametrize("step", [1, 1000])
def test_cohort_ref_equals_single_client_calls(step):
    rows, br, groups = 64, 8, 3
    p, g, m, v = _cohort_inputs(rows)
    gid = torch.tensor([0, 1, -1, 2, 2, 1, 0, -1], dtype=torch.int32)
    gmask = torch.tensor([[1, 0, 1], [1, 1, 1], [0, 1, 0], [1, 1, 1]], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32)        # client 3 padded
    sc = ops.adam_scalars(torch.tensor(step), 1e-3, 0.9, 0.999, 1e-8)
    out = masked_adam_cohort_ref(p, g, m, v, gid, gmask, valid, sc, block_rows=br)
    for c in range(CLIENTS):
        bm = ((gid >= 0) & (gmask[c, gid.clamp(min=0).long()] != 0)
              & bool(valid[c])).to(torch.int32)
        single = masked_adam_ref(p[c], g[c], m[c], v[c], bm, sc, block_rows=br)
        frozen = torch.repeat_interleave(bm == 0, br)
        for name, o, s, x in zip("pmv", out, single, (p, m, v)):
            assert torch.equal(o[c], s), f"client {c} {name}"
            assert torch.equal(o[c][frozen], x[c][frozen]), f"client {c} frozen {name}"
    for o, x in zip(out, (p, m, v)):                               # padded client
        assert torch.equal(o[3], x[3])


def test_cohort_wrapper_takes_the_plain_version_on_cpu():
    rows, br, steps = 64, 8, 3
    p, g, m, v = _cohort_inputs(rows)
    gid = torch.tensor([0, 1, -1, 1, 0, 0, 1, 1], dtype=torch.int32)
    gmask = torch.tensor([[1, 0], [0, 1], [1, 1], [1, 1]], dtype=torch.int32)
    step_valid = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [0, 0, 0]], np.float32)
    table = ops.adam_scalars(torch.arange(1, steps + 1), 1e-3, 0.9, 0.999, 1e-8)
    want = (p.clone(), m.clone(), v.clone())
    cohort = MaskedAdamCohort(p, m, v, gid, gmask, step_valid, table, block_rows=br)
    before = MaskedAdamCohort.launches
    for t in range(steps):
        gt = g * (t + 1)
        want = masked_adam_cohort_ref(*want[:1], gt, *want[1:], gid, gmask,
                                      torch.as_tensor(step_valid[:, t], dtype=torch.int32),
                                      table[t], block_rows=br)
        cohort.step(t, gt)
    assert MaskedAdamCohort.launches == before          # no kernel on the CPU
    for a, b in zip((p, m, v), want):
        assert torch.equal(a, b)


def test_cohort_wrapper_refuses_what_the_kernel_does_not_take():
    rows, br = 64, 8
    p, g, m, v = _cohort_inputs(rows)
    gid = torch.zeros(rows // br, dtype=torch.int32)
    gmask = torch.ones(CLIENTS, 2, dtype=torch.int32)
    sv = np.ones((CLIENTS, 2), np.float32)
    table = torch.ones(2, 4)
    ok = dict(p=p, m=m, v=v, gid=gid, gmask=gmask, step_valid=sv, scalars=table)
    shifted = torch.zeros(CLIENTS * rows * 128 + 1)[1:].view(CLIENTS, rows, 128)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    bad = [dict(m=shifted),                                # misaligned client slices
           dict(v=torch.zeros(CLIENTS, 128, rows).transpose(1, 2)),   # not contiguous
           dict(m=torch.zeros(CLIENTS, rows, 128, dtype=torch.float64)),
           dict(p=torch.zeros(CLIENTS, rows - 4, 128)),    # not a block multiple
           dict(p=torch.zeros(65536, 0, 128)),             # beyond the grid's y extent
           dict(step_valid=np.array([[0, 1]] * CLIENTS, np.float32)),   # head padding
           dict(step_valid=np.full((CLIENTS, 2), 0.5, np.float32)),
           dict(gid=torch.full((rows // br,), 2, dtype=torch.int32)),   # no such group
           dict(gid=gid.long()),
           dict(gmask=gmask[:2]),
           dict(scalars=torch.ones(3, 4))]
    for kw in bad:
        args = {**ok, **kw}
        with pytest.raises((ValueError, TypeError)):
            MaskedAdamCohort(args["p"], args["m"], args["v"], args["gid"], args["gmask"],
                             args["step_valid"], args["scalars"], block_rows=br)
    cohort = MaskedAdamCohort(p, m, v, gid, gmask, sv, table, block_rows=br)
    for gbad in (g[:2], g.double(), g.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            cohort.step(0, gbad)
    with pytest.raises(IndexError):
        cohort.step(2, g)


# -- stacked batches, masking, aggregation ------------------------------------

def test_stack_client_batches_identical():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((108, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 4, 108)
    parts = [np.arange(0, 12), np.arange(12, 48), np.arange(48, 68), np.arange(68, 108)]
    jc, tc = j_build_clients(x, y, parts), tpipe.build_clients(x, y, parts)
    a = j_stack_client_batches(jc, 16, 2, [3, 1, 4, 1])
    b = tpipe.stack_client_batches(tc, 16, 2, [3, 1, 4, 1])
    assert len(a) == len(b) == 2
    for ja, tb in zip(a, b):
        assert ja.members == tb.members
        for f in ("inputs", "labels", "step_valid"):
            assert np.array_equal(getattr(ja, f), getattr(tb, f)), f
        assert (tb.num_clients, tb.num_steps, tb.batch_width) == (
            ja.num_clients, ja.num_steps, ja.batch_width)


def test_stacked_masking_identical(resnet8):
    jtrees = [jax.tree.map(lambda a, c=c: a[c], resnet8["stacked"]) for c in range(CLIENTS)]
    ttrees = tmask.unstack_tree(resnet8["tstacked"], CLIENTS)
    _assert_trees_equal(jmask.stack_trees(jtrees), tmask.stack_trees(ttrees))
    for j, t in zip(jmask.unstack_tree(resnet8["stacked"], CLIENTS), ttrees):
        _assert_trees_equal(j, t)
    jm = jmask.mask_tree(resnet8["params"], resnet8["jpart"], (2, 5))
    tm = tmask.mask_tree(resnet8["tparams"], resnet8["tpart"], (2, 5))
    _assert_trees_equal(jmask.apply_mask_stacked(resnet8["stacked"], jm),
                        tmask.apply_mask_stacked(resnet8["tstacked"], tm))


def test_stacked_and_plan_aggregation_match_reference(resnet8):
    gp, tgp = resnet8["params"], resnet8["tparams"]
    st, tst = resnet8["stacked"], resnet8["tstacked"]
    jpart, tpart = resnet8["jpart"], resnet8["tpart"]
    w = [3.0, 1.0, 2.0, 5.0]
    _assert_trees_equal(jagg.tree_mean_stacked(st, w), tagg.tree_mean_stacked(tst, w),
                        AGG_TOL)
    _assert_trees_equal(jagg.aggregate_full_stacked(gp, st, w),
                        tagg.aggregate_full_stacked(tgp, tst, w), AGG_TOL)
    for group in (0, 4, 9):
        _assert_trees_equal(jagg.aggregate_partial_stacked(gp, st, jpart, group, w),
                            tagg.aggregate_partial_stacked(tgp, tst, tpart, group, w),
                            AGG_TOL)
    plan = _plan(CLIENTS)
    plan[:, 7] = False                                  # a group nobody trained
    assert np.array_equal(tagg.plan_group_denominators(plan, w),
                          jagg.plan_group_denominators(plan, w))
    ref = jagg.aggregate_plan_stacked(gp, st, jpart, plan, w)
    got = tagg.aggregate_plan_stacked(tgp, tst, tpart, plan, w)
    _assert_trees_equal(ref, got, AGG_TOL)
    jlist = [jax.tree.map(lambda a, c=c: a[c], st) for c in range(CLIENTS)]
    _assert_trees_equal(jagg.aggregate_plan(gp, jlist, jpart, plan, w),
                        tagg.aggregate_plan(tgp, tmask.unstack_tree(tst, CLIENTS),
                                            tpart, plan, w), AGG_TOL)
    for path, leaf in tree_paths(got):                  # untrained group, BN moments
        p = "/".join(path)
        if tpart.group_of(p) == 7 or is_local_stat(p):
            node = tgp
            for k in path:
                node = node[k]
            assert torch.equal(leaf, node), p
    with pytest.raises(ValueError):
        tagg.tree_mean_stacked(tst, [0.0] * CLIENTS)


# -- the C interface and the card ---------------------------------------------

def test_cohort_params_struct_matches_cuda_source():
    src = (build.CSRC / "masked_adam.cu").read_text()
    body = re.search(r"struct CohortParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?[\w]+\*?(?: long)?)\s+(.*)", decl).groups()
        fields += [(n.strip(), ctype) for n in names.split(",")]
    kinds = {"float*": ctypes.c_void_p, "const float*": ctypes.c_void_p,
             "const int32_t*": ctypes.c_void_p, "float": ctypes.c_float,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}
    assert [(n, kinds[t]) for n, t in fields] == madam_kernel._CohortParams._fields_


@pytest.mark.gpu
def test_cuda_cohort_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rows, br = 1576, 8
    p, g, m, v = (t.cuda() for t in _cohort_inputs(rows))
    gid = torch.randint(-1, 10, (rows // br,), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0)).cuda()
    gmask = torch.as_tensor(_plan(CLIENTS), dtype=torch.int32).cuda()
    sv = np.array([[1], [1], [1], [0]], np.float32)
    table = ops.adam_scalars(torch.tensor([1000], device="cuda"), 1e-3, 0.9, 0.999, 1e-8)
    ref = masked_adam_cohort_ref(p, g, m, v, gid, gmask,
                                 torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda"),
                                 table[0], block_rows=br)
    out = (p.clone(), m.clone(), v.clone())
    before = MaskedAdamCohort.launches
    MaskedAdamCohort(*out, gid, gmask, sv, table, block_rows=br).step(0, g)
    torch.cuda.synchronize()
    assert MaskedAdamCohort.launches == before + 1
    for k, r in zip(out, ref):
        assert torch.equal(k, r)
