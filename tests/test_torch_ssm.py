"""The port's Mamba2 half of ``models/ssm.py`` against the JAX package's.

* ``chunked_decay_attention`` (the plain chunked form) against the
  reference's, over the SSD kernel's cases (``test_torch_ssd_chunk.py``),
  with and without an initial state, and where the reference's
  multiply-by-mask overflows to NaN;
* ``mamba2_forward`` (``impl="kernel"``, which on the CPU is the SSD
  kernel's plain version, and ``impl="plain"``) and ``mamba2_decode`` on
  bridged ``zamba2-7b`` smoke params: outputs and caches, in f32, a short
  prompt (conv tail zero-padded) and a bf16 variant whose caches keep the
  reference's dtypes;
* ``mamba2_init`` / ``mamba2_cache_init`` trees, shapes and dtypes; the
  xLSTM blocks raise on an unknown ``impl`` and when the kernel path is
  differentiated (``test_torch_xlstm.py`` holds them against the
  reference);
* the reference's mLSTM at ``xlstm-125m``'s full widths (chunk 128) returns
  NaN, from the same multiply-by-mask, where the port's stays finite and
  its chunked scan within the SSD kernel's f32 tolerance of ``ssd_ref``.

Tolerances: the chunked form ≤ 1e-5 and caches ≤ 1e-5, block outputs ≤ 1e-4
(f32, sums in another order); bf16 outputs ≤ 5e-2 abs + rel (one bf16 ulp
is 2^-8 relative, rounded at several ops on both sides); the full-width
mLSTM scan ≤ 2e-4 abs + rel (``test_torch_ssd_chunk.py``'s f32 ``TOL``:
chunk sums reach −112 and values ~100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.kernels.ssd_chunk import ops
from repro_torch.models import ssm, transformer
from repro_torch.models.layers import linear
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

# the reference's functions under one jit each (one compile per shape, kept
# in the persistent XLA cache) rather than op by op
j_chunked = jax.jit(jssm.chunked_decay_attention, static_argnames=("chunk",))
j_forward = jax.jit(jssm.mamba2_forward, static_argnums=1)
j_decode = jax.jit(jssm.mamba2_decode, static_argnums=1)

CASES = [
    # (b, h, s, n, p, chunk) — tests/test_kernels_ssd.py, then zamba2-7b smoke,
    # a ragged chunk (S 12 < chunk 16) and slow decay over 8 chunks
    (1, 2, 128, 128, 128, 64),
    (2, 3, 256, 128, 128, 128),
    (1, 2, 128, 64, 128, 32),
    (1, 1, 256, 128, 64, 128),
    (2, 8, 32, 16, 32, 16),
    (2, 3, 12, 16, 32, 16),
    (1, 2, 512, 32, 32, 64),
]
SMOKE, SLOW = CASES[4], CASES[6]
REF_TOL = 1e-5
OUT_TOL = 1e-4
CACHE_TOL = 1e-5
BF16_TOL = 5e-2


def _inputs(case, seed=0):
    """q, k (B,S,H,N), v (B,S,H,P), log_a (B,S,H), f32 numpy: the
    reference's regime (decays in (0.8, 1)), or (0.99, 1) for ``SLOW``."""
    b, h, s, n, p, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, n)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, s, h, n)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if case == SLOW:
        log_a = -rng.uniform(0.0, 0.01, (b, s, h)).astype(np.float32)
    else:
        log_a = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.2
    return q, k, v, log_a


def _torch(arrs):
    return [bridge.from_numpy_tree({"x": a})["x"] for a in arrs]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(out: torch.Tensor, ref, tol: float, msg: str = "") -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _close_tree(got, want, tol: float) -> None:
    want = _np(want)
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        assert a.dtype == getattr(torch, b.dtype.name), path
        assert tuple(a.shape) == b.shape, path
        _close(a, b, tol, "/".join(path))


@pytest.mark.parametrize("case", CASES)
def test_chunked_form_matches_reference(case):
    q, k, v, la = _inputs(case, seed=3)
    y_j, st_j = j_chunked(*map(jnp.asarray, (q, k, v, la)),
                                             chunk=case[-1])
    y, st = ssm.chunked_decay_attention(*_torch((q, k, v, la)), case[-1])
    _close(y, y_j, REF_TOL)
    _close(st, st_j, REF_TOL)


def test_chunked_form_with_init_state_matches_reference():
    q, k, v, la = _inputs(SMOKE, seed=4)
    b, h, _, n, p, chunk = SMOKE
    s0 = np.random.default_rng(5).standard_normal((b, h, n, p)).astype(np.float32)
    y_j, st_j = j_chunked(*map(jnp.asarray, (q, k, v, la)),
                                             chunk=chunk, init_state=jnp.asarray(s0))
    y, st = ssm.chunked_decay_attention(*_torch((q, k, v, la)), chunk,
                                        init_state=torch.from_numpy(s0))
    _close(y, y_j, REF_TOL)
    _close(st, st_j, REF_TOL)
    with pytest.raises(ValueError, match="zero state"):
        ssm.chunked_decay_attention(*_torch((q, k, v, la)), chunk,
                                    init_state=torch.from_numpy(s0), impl="kernel")


def test_chunked_form_stays_finite_where_the_reference_overflows():
    """log_a = -1 per step: inside a chunk of 128, exp(cum_i - cum_j) above
    the diagonal reaches exp(127), which overflows f32; the reference
    multiplies it by the 0 of its causal mask and gets NaN.  The port
    selects, and agrees with the sequential recurrence."""
    b, h, s, n, p, chunk = 1, 2, 128, 16, 16, 128
    q, k, v, _ = _inputs((b, h, s, n, p, chunk), seed=6)
    la = np.full((b, s, h), -1.0, np.float32)
    y_j, _ = j_chunked(*map(jnp.asarray, (q, k, v, la)), chunk=chunk)
    assert np.isnan(np.asarray(y_j)).any()
    tq, tk, tv, tla = _torch((q, k, v, la))
    y, st = ssm.chunked_decay_attention(tq, tk, tv, tla, chunk)
    y_ref, st_ref = ops.ssd_reference(tq, tk, tv, tla)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, y_ref, rtol=REF_TOL, atol=REF_TOL)
    torch.testing.assert_close(st, st_ref, rtol=REF_TOL, atol=REF_TOL)


def test_chunked_form_gradients_stay_finite_where_exp_overflows():
    """The same overflowing input, differentiated: a select on exp's output
    passes its zero gradient through exp's inf as NaN (what xLSTM-125m's
    FedPart step at full width met: its loss NaN from the second step).
    The port selects on the exponent; its gradients are finite and agree
    with the sequential recurrence's, each within ``REF_TOL`` of its
    largest |gradient| (16-80 here: both sum 128 steps in f32, in other
    orders)."""
    b, h, s, n, p, chunk = 1, 2, 128, 16, 16, 128
    q, k, v, _ = _inputs((b, h, s, n, p, chunk), seed=6)
    la = np.full((b, s, h), -1.0, np.float32)
    grads = {}
    for name, fn in (("chunked", lambda *a: ssm.chunked_decay_attention(*a, chunk)),
                     ("ref", ops.ssd_reference)):
        xs = [x.requires_grad_() for x in _torch((q, k, v, la))]
        y, st = fn(*xs)
        (y.square().sum() + st.square().sum()).backward()
        grads[name] = [x.grad for x in xs]
    for g, g_ref in zip(grads["chunked"], grads["ref"]):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, g_ref, rtol=REF_TOL,
                                   atol=REF_TOL * float(g_ref.abs().max()))


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _block(dtype: str, seq: int, seed: int = 0):
    cfg = j_get_config("zamba2-7b", smoke=True).with_(param_dtype=dtype,
                                                       activation_dtype=dtype)
    params = _np(jssm.mamba2_init(jax.random.key(seed), cfg, jnp.dtype(dtype)))
    x = np.random.default_rng(seed).standard_normal((2, seq, cfg.d_model))
    x = np.asarray(jnp.asarray(x, jnp.dtype(dtype)))
    y, cache = j_forward(params, cfg, jnp.asarray(x))
    return cfg, params, x, np.asarray(y), _np(cache)


@pytest.fixture(scope="module")
def block():
    return _block("float32", 32)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mamba2_forward_matches_reference(block, impl):
    cfg, params, x, y_j, cache_j = block
    y, cache = ssm.mamba2_forward(bridge.from_numpy_tree(params), cfg, _torch([x])[0],
                                  impl=impl)
    _close(y, y_j, OUT_TOL)
    _close_tree(cache, cache_j, CACHE_TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mamba2_forward_short_prompt(impl):
    """S 2 < the conv width - 1: the conv tail is zero-padded in front."""
    cfg, params, x, y_j, cache_j = _block("float32", 2, seed=1)
    y, cache = ssm.mamba2_forward(bridge.from_numpy_tree(params), cfg, _torch([x])[0],
                                  impl=impl)
    _close(y, y_j, OUT_TOL)
    _close_tree(cache, cache_j, CACHE_TOL)
    assert not bool(cache["conv"][:, 0].any())


def test_mamba2_decode_matches_reference(block):
    cfg, params, x, _, cache_j = block
    x1 = np.random.default_rng(2).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    y_j, new_j = j_decode(params, cfg, jnp.asarray(x1),
                           jax.tree.map(jnp.asarray, cache_j))
    y, new = ssm.mamba2_decode(bridge.from_numpy_tree(params), cfg, _torch([x1])[0],
                               bridge.from_numpy_tree(cache_j))
    _close(y, y_j, OUT_TOL)
    _close_tree(new, new_j, CACHE_TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mamba2_bf16_keeps_the_reference_cache_dtypes(impl):
    """The kernel's f32 state is cast to v's dtype: both paths hand the
    cache over in the reference's dtypes (bf16 state and conv tail)."""
    cfg, params, x, y_j, cache_j = _block("bfloat16", 32, seed=3)
    y, cache = ssm.mamba2_forward(bridge.from_numpy_tree(params), cfg, _torch([x])[0],
                                  impl=impl)
    assert y.dtype == torch.bfloat16
    _close(y, y_j, BF16_TOL)
    _close_tree(cache, cache_j, BF16_TOL)


def test_mamba2_init_and_cache_init_match_reference():
    cfg = j_get_config("zamba2-7b", smoke=True).with_(param_dtype="bfloat16")
    want = jax.eval_shape(lambda: jssm.mamba2_init(jax.random.key(0), cfg, jnp.bfloat16))
    got = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    stacked = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                              "cpu", n=(2, 3))
    for (path, a), (_, s), (_, b) in zip(tree_paths(got), tree_paths(stacked),
                                         tree_paths(want)):
        assert tuple(a.shape) == b.shape and tuple(s.shape) == (2, 3) + b.shape, path
        assert a.dtype == s.dtype == getattr(torch, b.dtype.name), path
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    assert got["a_log"].dtype == got["dt_bias"].dtype == torch.float32
    want_c = jssm.mamba2_cache_init(cfg, 2, jnp.bfloat16)
    got_c = ssm.mamba2_cache_init(cfg, 2, torch.bfloat16, "cpu")
    _close_tree(got_c, want_c, 0.0)
    assert ssm.mamba2_cache_init(cfg, 2, torch.bfloat16, "cpu", n=4)["state"].shape == \
        (4,) + tuple(got_c["state"].shape)


def test_xlstm_blocks_raise():
    """The mLSTM refuses an unknown ``impl``, and its kernel path refuses to
    be differentiated (the kernel has no backward; training passes
    ``impl="plain"``); the assembly refuses an odd layer count."""
    cfg = j_get_config("xlstm-125m", smoke=True)
    params = ssm.mlstm_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(1, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="impl"):
        ssm.mlstm_forward(params, cfg, x, impl="pallas")
    with pytest.raises(RuntimeError, match="has no backward"):
        ssm.mlstm_forward(params, cfg, x.requires_grad_(True), impl="kernel")
    y, _ = ssm.mlstm_forward(params, cfg, x, impl="plain")
    assert y.requires_grad
    with pytest.raises(ValueError, match="pairs"):
        transformer.xlstm_init(torch.Generator(), cfg.with_(num_layers=3), "cpu")


# the ssd_chunk kernel's f32 tolerance (tests/test_torch_ssd_chunk.py TOL)
SCAN_TOL = 2e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_stays_finite_where_the_reference_overflows(dtype):
    """``xlstm-125m``'s full widths (8 heads of 192, chunk 128), one mLSTM
    layer from ``mlstm_init(jax.random.key(0))``, x ~ N(0, 1) of (1, 256,
    768) from ``jax.random.key(1)``: the forget gates' chunk sums reach
    about -112, so above the diagonal exp(cum_i - cum_j) overflows and the
    reference's multiply by the causal mask makes NaN in y (its final state
    stays finite).  The port stays finite on both paths; in f32 its
    chunked scan is within ``SCAN_TOL`` of the sequential recurrence
    (bf16's chunked form rounds the scores to bf16, as the reference's
    casts do, so it is held to finiteness only)."""
    cfg = j_get_config("xlstm-125m").with_(param_dtype=dtype, activation_dtype=dtype)
    jdt = jnp.dtype(dtype)
    params = jssm.mlstm_init(jax.random.key(0), cfg, jdt)
    x = jax.random.normal(jax.random.key(1), (1, 256, cfg.d_model)).astype(jdt)
    y_j, cache_j = jax.jit(jssm.mlstm_forward, static_argnums=1)(params, cfg, x)
    assert np.isnan(np.asarray(y_j, np.float32)).any()
    assert np.isfinite(np.asarray(cache_j["state"], np.float32)).all()

    tp, tx = bridge.from_numpy_tree(_np(params)), _torch([np.asarray(x)])[0]
    for impl in ssm.IMPLS:
        y, cache = ssm.mlstm_forward(tp, cfg, tx, impl=impl)
        assert bool(torch.isfinite(y.float()).all()), impl
        assert all(bool(torch.isfinite(c.float()).all()) for c in cache.values()), impl
    up = linear(tp["up_proj"], tx)
    q, k, v, i_raw, f_raw, _ = ssm._mlstm_qkv(tp, cfg, up[..., :up.shape[-1] // 2])
    log_f = torch.nn.functional.logsigmoid(f_raw)
    assert float(log_f.reshape(1, 2, 128, -1).sum(2).min()) < -100
    v_scaled = v * torch.exp(torch.clamp_max(i_raw, 8.0))[..., None].to(v.dtype)
    y, st = ssm.chunked_decay_attention(q, k, v_scaled, log_f, cfg.ssm_chunk)
    assert bool(torch.isfinite(y.float()).all())
    if dtype == "float32":
        y_ref, st_ref = ops.ssd_reference(q, k, v_scaled, log_f)
        torch.testing.assert_close(y, y_ref, rtol=SCAN_TOL, atol=SCAN_TOL)
        torch.testing.assert_close(st, st_ref, rtol=SCAN_TOL, atol=SCAN_TOL)
