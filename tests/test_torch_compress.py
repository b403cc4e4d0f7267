"""Transmitted-subtree compression (``core/compress.py``) against the JAX
package's ``repro.core.compress``, on the same seeded numpy inputs.

* ``qdq_leaf``: int8, onebit and topk, one scale per leaf and 1-row
  (128-element) blocks, ragged leaf sizes: within 5e-5 (the reference's
  ``COMPRESS_TOL``; int8 and topk agree exactly, onebit's block mean is a
  sum in another order); the stacked form equals the per-client one bit
  for bit;
* the wire format: encoded bytes exactly equal the reference's and the
  analytic ledger; int8 codes, sign bits and (tie-free) top-k indices
  exactly; ``decode_leaf(encode_leaf(x)) == qdq_leaf(x)`` bit for bit;
  top-k with tied magnitudes compares decoded values only (``torch.topk``
  and ``jax.lax.top_k`` may keep different indices among ties);
* error feedback telescopes: over rounds, ``sum(c) + r == sum(u)``;
* ``transmit_tree`` passes statistics and untrained groups through,
  ``transmit_tree_plan`` does the same per client, stacked or not;
* ``group_encoded_bytes``, ``tree_encoded_bytes`` and
  ``comm_cost(compression=...)`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.core import costs as jcosts
from repro.core.schedule import FedPartSchedule, matched_fnu
from repro.fl import resnet_task as j_resnet_task
from repro_torch import bridge
from repro_torch.core import compress as tc
from repro_torch.core import costs as tcosts
from repro_torch.core import masking as tmask
from repro_torch.core import schedule as tsched
from repro_torch.core.aggregation import is_local_stat
from repro_torch.fl import resnet_task
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

COMPRESS_TOL = 5e-5
SHAPES = [(), (1,), (300,), (7, 50), (3, 4, 130), (2, 129)]
CONFIGS = [(kind, br) for kind in ("int8", "onebit", "topk") for br in (0, 1)]


def _cfgs(kind, block_rows, fraction=0.05):
    kw = dict(topk_fraction=fraction, block_rows=block_rows)
    return jc.CompressionConfig(kind=kind, **kw), tc.CompressionConfig(kind=kind, **kw)


def _leaf(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def resnet():
    """ResNet-4's tree (BN running moments included) from the reference's
    init, and its partition on both sides."""
    jad = j_resnet_task("resnet4", num_classes=4)
    params = jax.tree.map(np.asarray, jad.init(jax.random.key(0)))
    tparams = bridge.from_numpy_tree(params)
    return params, jad.partition(params), tparams, \
        resnet_task("resnet4", num_classes=4).partition(tparams)


def _perturbed(params, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * rng.normal(0, 1, a.shape)).astype(a.dtype),
                        params)


def _assert_trees(jtree, ttree, tol=COMPRESS_TOL):
    ja, tb = tree_paths(jax.tree.map(np.asarray, jtree)), tree_paths(ttree)
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        np.testing.assert_allclose(b.numpy(), a, rtol=tol, atol=tol, err_msg="/".join(path))


@pytest.mark.parametrize("kind,block_rows", CONFIGS)
def test_qdq_leaf_matches_reference(kind, block_rows):
    jcfg, tcfg = _cfgs(kind, block_rows)
    for i, shape in enumerate(SHAPES):
        x = _leaf(shape, i)
        ref = np.asarray(jc.qdq_leaf(jnp.asarray(x), jcfg))
        out = tc.qdq_leaf(torch.as_tensor(x), tcfg)
        assert out.shape == tuple(shape) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=COMPRESS_TOL, atol=COMPRESS_TOL)
        if kind != "onebit":
            assert np.array_equal(out.numpy(), ref), (kind, shape)
    # stacked: each client's slice on its own, bit for bit
    xs = torch.as_tensor(_leaf((4, 3, 130), 9))
    got = tc.qdq_leaf(xs, tcfg, stacked=True)
    for c in range(4):
        assert torch.equal(got[c], tc.qdq_leaf(xs[c], tcfg))


@pytest.mark.parametrize("kind,block_rows", CONFIGS)
def test_wire_format_matches_reference(kind, block_rows):
    jcfg, tcfg = _cfgs(kind, block_rows)
    for i, shape in enumerate(SHAPES):
        x = _leaf(shape, 100 + i)
        jenc = jc.encode_leaf(x, jcfg)
        tenc = tc.encode_leaf(torch.as_tensor(x), tcfg)
        n = int(np.prod(shape))
        assert tenc.nbytes == jenc.nbytes == tc.leaf_encoded_bytes(n, tcfg) \
            == jc.leaf_encoded_bytes(n, jcfg)
        assert tenc.shape == tuple(shape) and tenc.payload.dtype == jenc.payload.dtype
        if kind == "topk":      # normal draws: no tied magnitudes
            assert np.array_equal(tenc.indices, jenc.indices)
            assert np.array_equal(tenc.payload, jenc.payload)
        else:
            assert np.array_equal(tenc.payload, jenc.payload)
            np.testing.assert_allclose(tenc.scales, jenc.scales, rtol=COMPRESS_TOL,
                                       atol=COMPRESS_TOL)
        dec = tc.decode_leaf(tenc, tcfg)
        assert torch.equal(dec, tc.qdq_leaf(torch.as_tensor(x), tcfg))
        np.testing.assert_allclose(dec.numpy(), np.asarray(jc.decode_leaf(jenc, jcfg)),
                                   rtol=COMPRESS_TOL, atol=COMPRESS_TOL)
    assert tc.leaf_encoded_bytes(0, tcfg) == 0
    assert tc.leaf_encoded_bytes(1000, None) == jc.leaf_encoded_bytes(1000, None) == 4000


def test_topk_ties_compare_values():
    """A leaf that is mostly zeros (an embedding row no client saw): k
    exceeds the nonzeros, so the kept zeros are a tie the two libraries may
    break differently; decoded values and bytes are the same."""
    x = np.zeros(1000, np.float32)
    x[::50] = _leaf((20,), 3)
    jcfg, tcfg = _cfgs("topk", 0, fraction=0.05)     # k = 50 > 20 nonzeros
    jenc, tenc = jc.encode_leaf(x, jcfg), tc.encode_leaf(torch.as_tensor(x), tcfg)
    assert tenc.nbytes == jenc.nbytes
    assert np.array_equal(tc.decode_leaf(tenc, tcfg).numpy(),
                          np.asarray(jc.decode_leaf(jenc, jcfg)))
    assert np.array_equal(tc.qdq_leaf(torch.as_tensor(x), tcfg).numpy(), x)
    # sign of zero: onebit maps it to +scale, as jnp.where(x >= 0, s, -s)
    jcfg, tcfg = _cfgs("onebit", 0)
    assert np.array_equal(tc.qdq_leaf(torch.as_tensor(x), tcfg).numpy() > 0,
                          np.asarray(jc.qdq_leaf(jnp.asarray(x), jcfg)) > 0)


@pytest.mark.parametrize("kind", ["int8", "onebit", "topk"])
def test_error_feedback_telescopes(kind):
    """Five rounds of one leaf's transmission: the residuals follow the
    reference's, and ``sum(c) + r == sum(u)`` holds on the port."""
    jcfg, tcfg = _cfgs(kind, 1)
    g = _leaf((5, 300), 0)
    jres, tres = jnp.zeros(g.shape, jnp.float32), torch.zeros(g.shape)
    sent, total = torch.zeros(g.shape), torch.zeros(g.shape)
    for r in range(5):
        local = g + 0.01 * _leaf(g.shape, 10 + r)
        jtx, jres = jc.transmit_leaf(jnp.asarray(g), jnp.asarray(local), jres, jcfg)
        ttx, tres = tc.transmit_leaf(torch.as_tensor(g), torch.as_tensor(local), tres, tcfg)
        np.testing.assert_allclose(ttx.numpy(), np.asarray(jtx), rtol=COMPRESS_TOL,
                                   atol=COMPRESS_TOL)
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=COMPRESS_TOL,
                                   atol=COMPRESS_TOL)
        sent += ttx - torch.as_tensor(g)
        total += torch.as_tensor(local) - torch.as_tensor(g)
    np.testing.assert_allclose((sent + tres).numpy(), total.numpy(), rtol=0, atol=1e-5)
    # without error feedback the residual stays zero
    cfg = tc.CompressionConfig(kind=kind, block_rows=1, error_feedback=False)
    _, res = tc.transmit_leaf(torch.as_tensor(g), torch.as_tensor(g) + 1, torch.zeros(g.shape),
                              cfg)
    assert not res.any()


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_transmit_tree_matches_reference(resnet, kind):
    """Statistics and untrained groups pass through untouched (value and
    residual); the transmitted groups agree with the reference."""
    params, jpart, tparams, tpart = resnet
    jcfg, tcfg = _cfgs(kind, 0)
    local = _perturbed(params, 1)
    jres = jax.tree.map(lambda a: 0.001 * np.ones(a.shape, np.float32), params)
    tres = bridge.from_numpy_tree(jres)
    tlocal = bridge.from_numpy_tree(local)
    for groups in (None, (2,), (0, 4)):
        jtx, jnr = jc.transmit_tree(params, local, jres, jcfg, partition=jpart,
                                    groups=groups)
        ttx, tnr = tc.transmit_tree(tparams, tlocal, tres, tcfg, partition=tpart,
                                    groups=groups)
        _assert_trees(jtx, ttx)
        _assert_trees(jnr, tnr)
        for (path, tx), (_, nr), (_, lo), (_, r0) in zip(
                tree_paths(ttx), tree_paths(tnr), tree_paths(tlocal), tree_paths(tres)):
            p = "/".join(path)
            sent = not is_local_stat(p) and (groups is None or tpart.group_of(p) in groups)
            if not sent:
                assert torch.equal(tx, lo) and torch.equal(nr, r0), p


def test_transmit_tree_plan_matches_reference(resnet):
    """A per-client plan: each client's row against the reference's traced
    variant, and the stacked form against the per-client one."""
    params, jpart, tparams, tpart = resnet
    jcfg, tcfg = _cfgs("int8", 1)
    plan = np.array([[1, 1, 0, 0, 1, 0], [0, 0, 0, 1, 0, 1], [1, 1, 1, 1, 1, 1]], bool)
    locals_ = [_perturbed(params, 5 + c) for c in range(3)]
    zero = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)
    per_client = []
    for c in range(3):
        jtx, jnr = jc.transmit_tree_plan(params, locals_[c], zero, jnp.asarray(plan[c]),
                                         jcfg, partition=jpart)
        ttx, tnr = tc.transmit_tree_plan(tparams, bridge.from_numpy_tree(locals_[c]),
                                         bridge.from_numpy_tree(zero), plan[c], tcfg,
                                         partition=tpart)
        _assert_trees(jtx, ttx)
        _assert_trees(jnr, tnr)
        per_client.append((ttx, tnr))
        # the structural form over the same group set gives the same values
        stx, snr = tc.transmit_tree(tparams, bridge.from_numpy_tree(locals_[c]),
                                    bridge.from_numpy_tree(zero), tcfg, partition=tpart,
                                    groups=tuple(np.flatnonzero(plan[c])))
        for a, b in zip(tree_paths(stx) + tree_paths(snr), tree_paths(ttx) + tree_paths(tnr)):
            assert torch.equal(a[1], b[1])
    stacked = tmask.stack_trees([bridge.from_numpy_tree(lo) for lo in locals_])
    res = tmask.stack_trees([bridge.from_numpy_tree(zero)] * 3)
    stx, snr = tc.transmit_tree_plan(tparams, stacked, res, torch.as_tensor(plan), tcfg,
                                     partition=tpart, stacked=True)
    for c, (ttx, tnr) in enumerate(per_client):
        for (_, a), (_, b) in zip(tree_paths(stx) + tree_paths(snr),
                                  tree_paths(ttx) + tree_paths(tnr)):
            assert torch.equal(a[c], b)


@pytest.mark.parametrize("kind,block_rows", CONFIGS)
def test_byte_books_match_reference(resnet, kind, block_rows):
    params, jpart, tparams, tpart = resnet
    jcfg, tcfg = _cfgs(kind, block_rows)
    assert np.array_equal(tc.group_encoded_bytes(tparams, tpart, tcfg),
                          jc.group_encoded_bytes(params, jpart, jcfg))
    assert np.array_equal(tc.group_encoded_bytes(tparams, tpart, None),
                          jc.group_encoded_bytes(params, jpart, None))
    assert tc.tree_encoded_bytes(tparams, tcfg) == jc.tree_encoded_bytes(params, jcfg)
    sub = tmask.select(tparams, tpart, 3)
    assert tc.tree_encoded_bytes(sub, tcfg) == tc.group_encoded_bytes(tparams, tpart, tcfg)[3]
    sched = FedPartSchedule(num_groups=6, warmup_rounds=1, rounds_per_layer=1, cycles=1,
                            bridge_rounds=1)
    for rounds in (sched.rounds(), matched_fnu(sched).rounds()):
        trounds = [tsched.RoundSpec(r.index, r.phase, r.cycle, r.group) for r in rounds]
        ja = jcosts.comm_cost(params, jpart, rounds, compression=jcfg)
        tb = tcosts.comm_cost(tparams, tpart, trounds, compression=tcfg)
        assert np.array_equal(ja.per_round_bytes, tb.per_round_bytes)
        assert (ja.total_bytes, ja.fnu_total_bytes) == (tb.total_bytes, tb.fnu_total_bytes)
        assert ja.ratio_to_fnu == tb.ratio_to_fnu


def test_make_config_matches_reference():
    assert tc.make_config("none") is None and jc.make_config("none") is None
    a = tc.make_config("topk", topk_fraction=0.1, error_feedback=False, block_rows=8)
    b = jc.make_config("topk", topk_fraction=0.1, error_feedback=False, block_rows=8)
    assert (a.kind, a.topk_fraction, a.error_feedback, a.block_rows, a.block_elems) == \
        (b.kind, b.topk_fraction, b.error_feedback, b.block_rows, b.block_elems)
    for bad in (dict(kind="zip"), dict(kind="none")):
        with pytest.raises(ValueError):
            tc.CompressionConfig(**bad)
    with pytest.raises(ValueError):
        tc.CompressionConfig(kind="topk", topk_fraction=0.0)
    with pytest.raises(ValueError):
        tc.make_config("zip")
