"""The port's MLA (``models/attention.py`` ``mla_init`` / ``mla_full`` /
``mla_decode``) against the JAX package's, on DeepSeek-V3's smoke config in
f32 with the reference's params (``mla_init(jax.random.key(seed))``)
bridged and numpy inputs:

* ``mla_init``: the reference's tree, shapes and dtypes, with and without
  ``q_lora_rank`` (``wq_a`` / ``q_norm`` / ``wq_b`` or one ``wq``);
* ``mla_full``: the output and the latent cache (``c_kv``, ``k_rope`` with
  RoPE applied), causal with window 0 and a window of 5, with and without
  ``q_lora_rank``; ``impl`` is checked and otherwise ignored (no kernel);
* ``mla_decode``: the output and both caches after the token's slot was
  written in place, at window 0 (slot = pos, part of the cache valid and
  all of it) and under a window (ring slots ``pos % W``, also past the
  first lap), with and without ``q_lora_rank``.

Tolerances: outputs and latent caches ≤ 1e-5 (abs + rel; f32, sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.models import attention
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-5
B, S = 2, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return bridge.from_numpy_tree({"x": np.asarray(a)})["x"]


def _cfg(q_lora: bool):
    cfg = j_get_config("deepseek-v3-671b", smoke=True)
    return cfg if q_lora else cfg.with_(q_lora_rank=0)


def _params(cfg, seed=0):
    return _np(jattn.mla_init(jax.random.key(seed), cfg, jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "no_q_lora"])
def test_mla_init_has_the_reference_tree(q_lora):
    cfg = _cfg(q_lora)
    jtree = tree_paths(jax.eval_shape(lambda: jattn.mla_init(jax.random.key(0), cfg,
                                                             jnp.bfloat16)))
    ttree = tree_paths(attention.mla_init(torch.Generator().manual_seed(0), cfg,
                                          torch.bfloat16, "cpu"))
    assert [p for p, _ in jtree] == [p for p, _ in ttree]
    assert (("wq_a", "w") in [p for p, _ in ttree]) == q_lora
    for (path, a), (_, b) in zip(jtree, ttree):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16, path


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "no_q_lora"])
def test_mla_full_matches_reference(q_lora, window):
    cfg = _cfg(q_lora)
    params = _params(cfg)
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jy, (jc, jr) = jattn.mla_full(params, cfg, x, pos, window=window)
    for impl in ("kernel", "plain"):
        y, (c, r) = attention.mla_full(bridge.from_numpy_tree(params), cfg, _t(x),
                                       _t(pos.copy()), window=window, impl=impl)
        assert c.shape == (B, S, cfg.kv_lora_rank) and r.shape == (B, S, cfg.qk_rope_head_dim)
        _close(y, jy)
        _close(c, jc)
        _close(r, jr)
    with pytest.raises(ValueError, match="impl"):
        attention.mla_full(bridge.from_numpy_tree(params), cfg, _t(x), _t(pos.copy()),
                           impl="pallas")


# (window, cache length W, pos): slot = pos at window 0 (part of the cache
# valid, then all of it); ring slots pos % W under a window, on the first lap
# and past it
DECODE = [(0, 10, 5), (0, 10, 9), (4, 4, 2), (4, 4, 6), (4, 4, 9)]


@pytest.mark.parametrize("window,w,pos", DECODE)
@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "no_q_lora"])
def test_mla_decode_matches_reference(q_lora, window, w, pos):
    cfg = _cfg(q_lora)
    params = _params(cfg, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cc = rng.standard_normal((B, w, cfg.kv_lora_rank)).astype(np.float32)
    rc = rng.standard_normal((B, w, cfg.qk_rope_head_dim)).astype(np.float32)
    jy, (jc, jr) = jattn.mla_decode(params, cfg, x, cc, rc, jnp.int32(pos), window=window)
    tc, tr = _t(cc), _t(rc)
    y, (c, r) = attention.mla_decode(bridge.from_numpy_tree(params), cfg, _t(x), tc, tr,
                                     pos, window=window)
    assert c is tc and r is tr                      # written in place
    slot = pos % w if window else pos
    changed = np.flatnonzero((tc.numpy() != cc).any(axis=(0, 2)))
    assert changed.tolist() == [slot]
    _close(y, jy)
    _close(tc, jc)
    _close(tr, jr)
