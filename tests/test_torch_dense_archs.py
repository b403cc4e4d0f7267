"""The port's other dense decoders against the JAX package's: ``gemma-2b``
(GeGLU, MQA, tied embeddings, head dim 256 at full size), ``llama3.2-1b``
(GQA 32/8, tied, RoPE theta 500k) and ``glm4-9b`` (GQA 32/2, untied).

For each, on its smoke config in f32 with the reference's params
(``api.init(jax.random.key(seed))``) bridged:

* the port's configs equal the reference's, full and smoke;
* the port's own init has the reference's tree, shapes and dtypes (f32 and
  bf16), and so has its decode cache;
* ``decoder_forward`` (``impl="plain"`` and ``impl="kernel"``, which on the
  CPU is the flash kernel's plain version) against the reference's
  ``impl="xla"``: logits and KV caches;
* ``decoder_decode_step`` against the reference's;
* ``serve_session`` on the CPU against the reference's prefill / serve steps
  (greedy tokens equal, every step's logits close);
* Gemma's smoke config at head dim 256 (``with_(head_dim=256)``), so that
  D 256 goes through the port's attention wrapper, against the reference's
  forward, and its one-token decode.

Inputs come from numpy seeds.  Tolerances as ``tests/test_torch_transformer.py``:
logits ≤ 1e-4 and caches ≤ 1e-5 (f32, sums in another order); tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro.models.api import InputShape
from repro_torch import bridge
from repro_torch.configs import available_archs, get_config
from repro_torch.launch import serve
from repro_torch.models import api, transformer
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

ARCHS = ["gemma-2b", "llama3.2-1b", "glm4-9b"]
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
BATCH, PROMPT, GEN = 2, 12, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return bridge.from_numpy_tree({"x": np.asarray(a)})["x"]


def _close_tree(got, want, tol):
    wflat, gflat = tree_paths(_np(want)), tree_paths(got)
    assert [p for p, _ in wflat] == [p for p, _ in gflat]
    for (path, a), (_, b) in zip(wflat, gflat):
        assert tuple(a.shape) == tuple(b.shape), path
        np.testing.assert_allclose(b.numpy(), a, rtol=tol, atol=tol, err_msg="/".join(path))


def _smoke(arch, **kw):
    cfg = j_get_config(arch, smoke=True).with_(**kw)
    params = _np(japi.init(jax.random.key(0), cfg))
    return cfg, params, bridge.from_numpy_tree(params)


@pytest.fixture(scope="module")
def smoke_models():
    return {}


def _model(cache, arch):
    if arch not in cache:
        cache[arch] = _smoke(arch)
    return cache[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(arch, smoke=smoke))
    assert arch in available_archs()


def test_full_sizes_are_the_served_ones():
    """The full configs' head dims, and the one the flash kernel runs at DP 256."""
    dims = {a: get_config(a).resolved_head_dim for a in ARCHS}
    assert dims == {"gemma-2b": 256, "llama3.2-1b": 64, "glm4-9b": 128}
    gemma = get_config("gemma-2b")
    assert (gemma.mlp_kind, gemma.tie_embeddings, gemma.num_kv_heads) == ("geglu", True, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_tree(arch, dtype):
    cfg = j_get_config(arch, smoke=True).with_(param_dtype=dtype, activation_dtype=dtype)
    jtree = tree_paths(jax.eval_shape(lambda: japi.init(jax.random.key(0), cfg)))
    ttree = tree_paths(api.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    assert [p for p, _ in jtree] == [p for p, _ in ttree]
    for (path, a), (_, b) in zip(jtree, ttree):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype) == f"torch.{a.dtype}", path
    jcache = tree_paths(japi.cache_init(cfg, 2, 9, jnp.dtype(dtype)))
    tcache = tree_paths(api.cache_init(cfg, 2, 9, getattr(torch, dtype), "cpu"))
    assert [(p, tuple(a.shape)) for p, a in jcache] == \
        [(p, tuple(b.shape)) for p, b in tcache]


def _forward_matches(cfg, params, tparams, impl, seed):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc, _ = jtransformer.decoder_forward(params, cfg, jnp.asarray(tokens), impl="xla",
                                             collect_cache=True)
    tl, tc, taux = transformer.decoder_forward(tparams, cfg, _t(tokens), impl=impl,
                                               collect_cache=True)
    assert tl.dtype == torch.float32 and float(taux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _close_tree(tc, jc, CACHE_TOL)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decoder_forward_matches_xla(smoke_models, arch, impl):
    _forward_matches(*_model(smoke_models, arch), impl, seed=5)


def _decode_matches(cfg, params, tparams, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    _, jc, _ = jtransformer.decoder_forward(params, cfg, jnp.asarray(tokens),
                                            collect_cache=True)
    pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])  # noqa: E731
    jc = jax.tree.map(pad, jc)
    tc = bridge.from_numpy_tree(_np(jc))
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, jnc = jtransformer.decoder_decode_step(params, cfg, jnp.asarray(tok), jc,
                                               jnp.int32(8))
    tl, tnc = transformer.decoder_decode_step(tparams, cfg, _t(tok), tc, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _close_tree(tnc, jnc, CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(smoke_models, arch):
    _decode_matches(*_model(smoke_models, arch), seed=6)


@pytest.fixture(scope="module")
def references():
    return {}


def _reference_serve(cache, arch):
    """The reference's params, prompt and greedy run with every step's logits
    (its ``serve_session``'s loop, unrolled to keep them)."""
    if arch in cache:
        return cache[arch]
    cfg = j_get_config(arch, smoke=True)
    key = jax.random.key(3)
    params = japi.init(key, cfg)
    prompt = japi.synth_batch(jax.random.fold_in(key, 1), cfg,
                              InputShape("serve", PROMPT, BATCH, "prefill"))
    prefill = jax.jit(jsteps.make_prefill_step(cfg))
    step = jax.jit(jsteps.make_serve_step(cfg))
    logits, kv = prefill(params, prompt)
    kv = jserve._grow_attention_caches(kv, PROMPT, PROMPT + GEN)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    toks, all_logits = [tok], [logits]
    for i in range(GEN - 1):
        logits, kv = step(params, tok, kv, jnp.int32(PROMPT + i))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
        all_logits.append(logits)
    cache[arch] = {"cfg": cfg, "params": _np(params), "prompt": _np(prompt),
                   "tokens": np.asarray(jnp.concatenate(toks, axis=1)),
                   "logits": [np.asarray(x) for x in all_logits]}
    return cache[arch]


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_matches_reference(references, arch, impl):
    ref = _reference_serve(references, arch)
    res = serve.serve_session(ref["cfg"], BATCH, PROMPT, GEN, device="cpu", impl=impl,
                              params=bridge.from_numpy_tree(ref["params"]),
                              prompt=bridge.from_numpy_tree(ref["prompt"]), verbose=False)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (BATCH, GEN)
    np.testing.assert_array_equal(res.tokens.numpy(), ref["tokens"])
    assert len(res.logits) == GEN
    for i, (t, j) in enumerate(zip(res.logits, ref["logits"])):
        assert tuple(t.shape) == j.shape == (BATCH, 1, ref["cfg"].vocab_size)
        np.testing.assert_allclose(t.numpy(), j, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")


@pytest.fixture(scope="module")
def gemma_d256():
    return _smoke("gemma-2b", head_dim=256)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_gemma_head_dim_256_forward_matches_xla(gemma_d256, impl):
    cfg = gemma_d256[0]
    assert cfg.resolved_head_dim == 256 and cfg.num_kv_heads == 1
    _forward_matches(*gemma_d256, impl, seed=7)


def test_gemma_head_dim_256_decode_matches_reference(gemma_d256):
    _decode_matches(*gemma_d256, seed=8)
