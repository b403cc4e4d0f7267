"""The port's fused masked Adam against the JAX package's.

* the plain PyTorch version (what the wrapper runs for a CPU tensor) against
  the Pallas ``masked_adam_kernel`` in interpret mode and the jnp
  ``masked_adam_ref``, over shapes, block sizes, steps and masks; frozen
  blocks stay bit-exact;
* ``ops.pack`` layout and the block masks are identical to the reference's
  on ResNet-8 (1,576 rows, 197 blocks);
* the client-stacked launch equals per-client launches (both are cohort
  launches: one kernel stands for both TPU functions);
* the three realisations of Eq. 1 (fused == masked == partitioned), and the
  unfused ``adam_update`` against the reference's;
* the CUDA kernel against the plain version, on a card only (``gpu``).

Tolerance 1e-6: the same f32 operations in the same order on both sides;
only the platforms' sqrt / pow rounding (≤ a few ulp) differs.
"""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import is_local_stat as j_is_local_stat
from repro.fl.tasks import resnet_task
from repro.kernels.masked_adam import ops as jops
from repro.kernels.masked_adam.kernel import masked_adam_kernel
from repro.kernels.masked_adam.ref import masked_adam_ref as j_ref
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as j_adam_init
from repro.optim.adam import adam_update as j_adam_update
from repro_torch import bridge
from repro_torch.core import masking
from repro_torch.core.aggregation import is_local_stat
from repro_torch.core.partition import build_partition as t_build_partition
from repro_torch.fl import tasks as ttasks
from repro_torch.kernels import build
from repro_torch.kernels.masked_adam import kernel as madam_kernel
from repro_torch.kernels.masked_adam import (MaskedAdamCohort, masked_adam_,
                                             masked_adam_ref, masked_adam_stacked_, ops)
from repro_torch.optim import adam as tadam
from repro_torch.optim import partial as tpartial
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from tests.conftest import small_params

TOL = 1e-6

# One torch thread per test process: the suite runs several pytest workers
# at once, and torch's default of one thread per core oversubscribes the box
# (about 4x slower with six workers on 8 cores).  It also avoids a torch-on-
# CPU quirk: the first multi-threaded torch.sqrt of a process can return
# values ~1e-4 off in one worker thread's chunk (a one-time math-library
# initialisation race).
torch.set_num_threads(1)


def _inputs(rows, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((rows, 128)).astype(np.float32)
    g = rng.standard_normal((rows, 128)).astype(np.float32)
    m = (rng.standard_normal((rows, 128)) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal((rows, 128))) * 0.01).astype(np.float32)
    return p, g, m, v


def _mask(kind, nb, seed):
    if kind == "all-on":
        return np.ones(nb, np.int32)
    if kind == "all-off":
        return np.zeros(nb, np.int32)
    return np.random.default_rng(seed).integers(0, 2, nb).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_kernel(br):
    return jax.jit(functools.partial(masked_adam_kernel, block_rows=br,
                                     interpret=True))


@pytest.mark.parametrize("rows,br", [(32, 8), (64, 16), (1576, 8)])
@pytest.mark.parametrize("step", [1, 1000])
@pytest.mark.parametrize("kind", ["random", "all-on", "all-off"])
def test_plain_matches_jax_kernel_and_ref(rows, br, step, kind):
    p, g, m, v = _inputs(rows, seed=rows + step)
    mask = _mask(kind, rows // br, seed=step)
    sc = np.asarray(jops.adam_scalars(jnp.int32(step), 1e-3, 0.9, 0.999, 1e-8))
    jk = _jax_kernel(br)(*map(jnp.asarray, (p, g, m, v, mask, sc)))
    jr = j_ref(*map(jnp.asarray, (p, g, m, v, mask, sc)), block_rows=br)
    tp, tm, tv = (torch.tensor(a) for a in (p, m, v))
    out = masked_adam_(tp, torch.tensor(g), tm, tv, torch.tensor(mask),
                       torch.tensor(sc), block_rows=br)
    assert out[0] is tp and out[1] is tm and out[2] is tv     # in place
    frozen = np.repeat(mask == 0, br)
    for name, t, a, b, x in zip("pmv", out, jk, jr, (p, m, v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=TOL, atol=TOL,
                                   err_msg=f"{name} vs kernel")
        np.testing.assert_allclose(t.numpy(), np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=f"{name} vs ref")
        assert np.array_equal(t.numpy()[frozen], x[frozen]), f"frozen {name}"


@pytest.mark.parametrize("step", [1, 2, 7, 1000])
def test_adam_scalars_match_jax(step):
    a = np.asarray(jops.adam_scalars(jnp.int32(step), 2e-3, 0.9, 0.999, 1e-3))
    b = ops.adam_scalars(torch.tensor(step), 2e-3, 0.9, 0.999, 1e-3).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-7, atol=0)
    table = ops.adam_scalars(torch.arange(1, step + 1), 2e-3, 0.9, 0.999, 1e-3)
    assert table.shape == (step, 4) and torch.equal(table[-1], torch.tensor(b))


@pytest.fixture(scope="module")
def resnet8():
    params = jax.tree.map(np.asarray, resnet_task("resnet8").init(jax.random.key(1)))
    tparams = bridge.from_numpy_tree(params)
    return params, tparams, resnet_task("resnet8").partition(params), \
        ttasks.resnet_task("resnet8").partition(tparams)


def test_pack_layout_identical_on_resnet8(resnet8):
    params, tparams, _, _ = resnet8
    jp, jmeta = jops.pack(params, 8)
    tp, tmeta = ops.pack(tparams, 8)
    assert tp.shape == (1576, 128) == jp.shape
    assert ops.packed_rows(tparams, 8) == jops.packed_rows(params, 8) == 1576
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert (tmeta.shapes, tmeta.sizes, tmeta.padded) == \
        (jmeta.shapes, jmeta.sizes, jmeta.padded)
    back = ops.unpack(tp, tmeta)
    for (_, a), (_, b) in zip(tree_paths(back), tree_paths(tparams)):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() == tp.untyped_storage().data_ptr()


def test_block_masks_identical_on_resnet8(resnet8):
    params, tparams, jpart, tpart = resnet8
    for exclude in (None, "stats"):
        je = j_is_local_stat if exclude else None
        te = is_local_stat if exclude else None
        a = jops.block_group_ids(params, jpart, 8, exclude=je)
        b = ops.block_group_ids(tparams, tpart, 8, exclude=te)
        assert np.array_equal(a, b) and len(b) == 197
        for groups in [*range(10), tuple(range(10)), (2, 7)]:
            assert np.array_equal(
                jops.block_mask_for_group(params, jpart, groups, 8, exclude=je),
                ops.block_mask_for_group(tparams, tpart, groups, 8, exclude=te))


def test_stacked_equals_per_client():
    clients, rows, br = 3, 64, 8
    rng = np.random.default_rng(4)
    p, g, m, v = (torch.tensor(rng.standard_normal((clients, rows, 128)),
                               dtype=torch.float32) for _ in range(4))
    v = v.abs()
    masks = torch.tensor(rng.integers(0, 2, (clients, rows // br)), dtype=torch.int32)
    sc = ops.adam_scalars(torch.tensor(3), 1e-3, 0.9, 0.999, 1e-8)
    per = [masked_adam_ref(p[c], g[c], m[c], v[c], masks[c], sc, block_rows=br)
           for c in range(clients)]
    masked_adam_stacked_(p, g, m, v, masks, sc, block_rows=br)
    for c, (pc, mc, vc) in enumerate(per):
        assert torch.equal(p[c], pc) and torch.equal(m[c], mc) and torch.equal(v[c], vc)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = torch.zeros(16, 128)
    ok = dict(g=torch.zeros(16, 128), m=torch.zeros(16, 128), v=torch.zeros(16, 128),
              block_mask=torch.ones(2, dtype=torch.int32), scalars=torch.ones(4))
    bad = [dict(g=torch.zeros(16, 128, dtype=torch.float64)),
           dict(m=torch.zeros(8, 128)),
           dict(v=torch.zeros(128, 16).t()),
           dict(block_mask=torch.ones(2, dtype=torch.int64)),
           dict(block_mask=torch.ones(3, dtype=torch.int32)),
           dict(scalars=torch.ones(3))]
    for kw in bad:
        args = {**ok, **kw}
        with pytest.raises((ValueError, TypeError)):
            masked_adam_(p, args["g"], args["m"], args["v"], args["block_mask"],
                         args["scalars"])
    with pytest.raises(ValueError):
        masked_adam_(torch.zeros(12, 128), *(torch.zeros(12, 128) for _ in range(3)),
                     torch.ones(1, dtype=torch.int32), torch.ones(4), block_rows=8)


def _quad_loss(tree):
    """A loss touching every leaf non-trivially: sum of (w + 0.1)^2 / 2 and
    a coupled term, so gradients differ per leaf."""
    leaves = tree_leaves(tree)
    loss = sum(0.5 * torch.sum((w.float() + 0.1) ** 2) for w in leaves)
    return loss + 0.01 * torch.sum(leaves[0].float()) * torch.sum(leaves[-1].float())


def test_three_way_fused_masked_partitioned():
    params = bridge.from_numpy_tree(jax.tree.map(np.asarray, small_params()))
    part = t_build_partition(params)
    cfg = tadam.AdamConfig(lr=1e-2, eps=1e-3)
    for group in range(part.num_groups):
        packed = tpartial.PackedTree.from_tree(params, 8)
        gid = torch.as_tensor(ops.block_group_ids(params, part, 8))
        row = torch.as_tensor((np.arange(part.num_groups) == group).astype(np.int32))
        table = ops.adam_scalars(torch.arange(1, 4), cfg.lr, cfg.b1, cfg.b2, cfg.eps)
        adam = tpartial.fused_adam(packed, gid, row, table, cfg)
        mparams, mstate = params, tadam.adam_init(params)
        mask = masking.mask_tree(params, part, group)
        pparams, pstate = params, None
        for i in range(3):
            floss, _ = tpartial.fused_masked_step(
                lambda t: (_quad_loss(t), None), packed, adam, i)
            mparams, mstate, mloss = tpartial.masked_step(
                _quad_loss, mparams, mstate, mask, cfg)
            pparams, pstate, ploss = tpartial.partitioned_step(
                _quad_loss, pparams, part, group, pstate, cfg)
            assert abs(float(floss) - float(mloss)) <= TOL * abs(float(mloss))
            assert abs(float(ploss) - float(mloss)) <= TOL * abs(float(mloss))
        fused = packed.detached()
        for f, m_, p_, x in zip(tree_leaves(fused), tree_leaves(mparams),
                                tree_leaves(pparams), tree_leaves(params)):
            torch.testing.assert_close(f, m_, rtol=TOL, atol=TOL)
            torch.testing.assert_close(p_, m_, rtol=TOL, atol=TOL)
        # frozen leaves never move in any form
        for (path, f), x in zip(tree_paths(fused), tree_leaves(params)):
            if part.group_of(path) != group:
                assert torch.equal(f, x)
    with pytest.raises(ValueError):
        tpartial.guard_fused_config(tadam.AdamConfig(weight_decay=0.1))
    with pytest.raises(TypeError):
        tpartial.PackedTree.from_tree({"w": torch.zeros(3, dtype=torch.float64)})


def test_adam_update_matches_jax():
    rng = np.random.default_rng(9)
    params = jax.tree.map(np.asarray, small_params())
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                          params) for _ in range(3)]
    jcfg, tcfg = JAdamConfig(lr=1e-3), tadam.AdamConfig(lr=1e-3)
    jp, js = params, j_adam_init(params)
    tp, ts = bridge.from_numpy_tree(params), tadam.adam_init(bridge.from_numpy_tree(params))
    for gr in grads:
        jp, js = j_adam_update(gr, js, jp, jcfg)
        tp, ts = tadam.adam_update(bridge.from_numpy_tree(gr), ts, tp, tcfg)
    assert int(ts.step) == 3
    for (path, a), (_, b) in zip(tree_paths(jax.tree.map(np.asarray, jp)),
                                 tree_paths(tree_map(lambda t: t.numpy(), tp))):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg="/".join(path))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1576, 4096])
def test_cuda_kernel_matches_plain(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    p, g, m, v = (torch.tensor(a, device="cuda") for a in _inputs(rows, seed=5))
    mask = torch.tensor(_mask("random", rows // 8, seed=2), device="cuda")
    sc = ops.adam_scalars(torch.tensor(1000, device="cuda"), 1e-3, 0.9, 0.999, 1e-8)
    ref = masked_adam_ref(p, g, m, v, mask, sc)
    before = MaskedAdamCohort.launches
    out = (p.clone(), m.clone(), v.clone())
    masked_adam_(out[0], g, out[1], out[2], mask, sc)
    torch.cuda.synchronize()
    assert MaskedAdamCohort.launches == before + 1
    frozen = torch.repeat_interleave(mask == 0, 8)
    for k, r, x in zip(out, ref, (p, m, v)):
        torch.testing.assert_close(k, r, rtol=TOL, atol=TOL)
        assert torch.equal(k[frozen], x[frozen])


def test_launcher_declares_its_c_signature(monkeypatch):
    """The argument struct's pointer and the stream go to the C launcher as
    ``c_void_p`` (ctypes would pass a bare Python int as a 32-bit int);
    ctypes' default ``restype`` is already ``c_int``, so the declaration
    must not hinge on it."""
    launch = type("Launch", (), {"argtypes": None, "restype": ctypes.c_int})()
    lib = type("Lib", (), {"masked_adam_cohort_launch": launch})()
    monkeypatch.setattr(build, "load", lambda name: lib)
    fn = madam_kernel._cohort_launcher()
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
