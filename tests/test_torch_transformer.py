"""The port's dense GQA decoder against the JAX package's, on bridged
``tinyllama-1.1b`` smoke params in f32.

* configs: the port's copy equals the reference's, field for field;
* layers: norms, linear, embed / unembed, the three MLPs, RoPE;
* ``gqa_full`` (``impl="plain"`` and ``impl="kernel"``, which on the CPU is
  the flash kernel's plain version) against the reference's ``impl="xla"``,
  causal, windowed and non-causal; the reference's ``impl="pallas"`` path
  drops ``window`` / ``causal`` (it documents that defect, which the port
  does not copy); ``gqa_decode`` against the reference;
* ``decoder_forward`` logits and KV caches, ``decoder_decode_step`` and
  ``lm_loss`` against the reference; the port's own init has the
  reference's tree, shapes and dtypes.

Tolerances: logits ≤ 1e-4 and caches ≤ 1e-5 (f32, sums in another order);
layers ≤ 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import api, attention, layers, transformer
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
LAYER_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return bridge.from_numpy_tree({"x": np.asarray(a)})["x"]


@pytest.fixture(scope="module")
def smoke():
    cfg = j_get_config("tinyllama-1.1b", smoke=True)
    params = _np(japi.init(jax.random.key(0), cfg))
    return cfg, params, bridge.from_numpy_tree(params)


def test_configs_equal_the_reference():
    for smoke_ in (False, True):
        a = dataclasses.asdict(j_get_config("tinyllama-1.1b", smoke=smoke_))
        b = dataclasses.asdict(get_config("tinyllama-1.1b", smoke=smoke_))
        assert a == b
    assert dataclasses.asdict(get_config("whisper-small")) == \
        dataclasses.asdict(j_get_config("whisper-small"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    tx = _t(x)
    for jfn, tfn, p in ((jlayers.rmsnorm, layers.rmsnorm, {"scale": scale}),
                        (jlayers.layernorm, layers.layernorm,
                         {"scale": scale, "bias": bias})):
        tp = bridge.from_numpy_tree(p)
        np.testing.assert_allclose(tfn(tp, tx).numpy(), np.asarray(jfn(p, x)),
                                   rtol=LAYER_TOL, atol=LAYER_TOL)
    lin = {"w": rng.standard_normal((16, 8)).astype(np.float32),
           "b": rng.standard_normal(8).astype(np.float32)}
    np.testing.assert_allclose(layers.linear(bridge.from_numpy_tree(lin), tx).numpy(),
                               np.asarray(jlayers.linear(lin, x)),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    table = {"table": rng.standard_normal((11, 16)).astype(np.float32)}
    ids = rng.integers(0, 11, (2, 5)).astype(np.int32)
    ttab = bridge.from_numpy_tree(table)
    np.testing.assert_array_equal(layers.embed(ttab, _t(ids)).numpy(),
                                  np.asarray(jlayers.embed(table, ids)))
    np.testing.assert_allclose(layers.unembed(ttab, tx).numpy(),
                               np.asarray(jlayers.unembed(table, x)),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    for kind in ("swiglu", "geglu", "gelu"):
        mp = _np(jlayers.mlp_init(jax.random.key(1), kind, 16, 32, jnp.float32))
        np.testing.assert_allclose(
            layers.mlp_apply(bridge.from_numpy_tree(mp), kind, tx).numpy(),
            np.asarray(jlayers.mlp_apply(mp, kind, x)),
            rtol=LAYER_TOL, atol=LAYER_TOL, err_msg=kind)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32)[None] + 100, (2, 7))
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 32, 10_000.0)
    tc, ts = layers.rope_angles(_t(pos), 32, 10_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=LAYER_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=LAYER_TOL)
    np.testing.assert_allclose(layers.apply_rope(_t(x), tc, ts).numpy(),
                               np.asarray(jlayers.apply_rope(x, jc, js)),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


def _attn_inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s)).copy()
    return x, pos


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_gqa_full_matches_xla(smoke, impl, causal, window):
    cfg, params, _ = smoke
    p = _np(_layer0(params["blocks"]["attn"]))
    x, pos = _attn_inputs(cfg, 12, seed=2)
    jy, (jk, jv) = jattn.gqa_full(p, cfg, x, pos, window=window, causal=causal,
                                  impl="xla")
    ty, (tk, tv) = attention.gqa_full(bridge.from_numpy_tree(p), cfg, _t(x), _t(pos),
                                      window=window, causal=causal, impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=CACHE_TOL, atol=CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=CACHE_TOL, atol=CACHE_TOL)


@pytest.mark.parametrize("causal,window", [(True, 5), (False, 0)])
def test_reference_pallas_path_drops_the_mask(smoke, causal, window):
    """The reference's ``_sdpa(impl="pallas")`` hands only ``mask=`` to its
    kernel wrapper, which ignores it: asked for a window or for non-causal
    attention it still computes plain causal attention.  The port's kernel
    path computes what it is asked (held against xla above)."""
    cfg, params, _ = smoke
    p = _np(_layer0(params["blocks"]["attn"]))
    x, pos = _attn_inputs(cfg, 12, seed=3)
    asked, _ = jattn.gqa_full(p, cfg, x, pos, window=window, causal=causal, impl="xla")
    plain_causal, _ = jattn.gqa_full(p, cfg, x, pos, impl="xla")
    pallas, _ = jattn.gqa_full(p, cfg, x, pos, window=window, causal=causal,
                               impl="pallas")
    np.testing.assert_allclose(np.asarray(pallas), np.asarray(plain_causal),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert np.abs(np.asarray(pallas) - np.asarray(asked)).max() > 1e-3
    ty, _ = attention.gqa_full(bridge.from_numpy_tree(p), cfg, _t(x), _t(pos),
                               window=window, causal=causal, impl="kernel")
    np.testing.assert_allclose(ty.numpy(), np.asarray(asked), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("window,pos", [(0, 5), (0, 9), (4, 6)])
def test_gqa_decode_matches_reference(smoke, window, pos):
    cfg, params, _ = smoke
    p = _np(_layer0(params["blocks"]["attn"]))
    rng = np.random.default_rng(4)
    w = 4 if window else 10
    hd = cfg.resolved_head_dim
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((2, w, cfg.num_kv_heads, hd)).astype(np.float32)
    vc = rng.standard_normal((2, w, cfg.num_kv_heads, hd)).astype(np.float32)
    jy, (jk, jv) = jattn.gqa_decode(p, cfg, x, kc, vc, jnp.int32(pos), window=window)
    tk, tv = _t(kc), _t(vc)
    ty, (rk, rv) = attention.gqa_decode(bridge.from_numpy_tree(p), cfg, _t(x), tk, tv,
                                        pos, window=window)
    assert rk is tk and rv is tv                    # written in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=CACHE_TOL, atol=CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=CACHE_TOL, atol=CACHE_TOL)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_decoder_forward_matches_xla(smoke, impl):
    cfg, params, tparams = smoke
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc, jaux = jtransformer.decoder_forward(params, cfg, jnp.asarray(tokens),
                                                impl="xla", collect_cache=True)
    tl, tc, taux = transformer.decoder_forward(tparams, cfg, _t(tokens), impl=impl,
                                               collect_cache=True)
    assert tl.dtype == torch.float32 and float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    jflat, tflat = tree_paths(_np(jc)), tree_paths(tc)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == tuple(b.shape), path
        np.testing.assert_allclose(b.numpy(), a, rtol=CACHE_TOL, atol=CACHE_TOL,
                                   err_msg="/".join(path))


def test_decode_step_and_loss_match_reference(smoke):
    cfg, params, tparams = smoke
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    _, jc, _ = jtransformer.decoder_forward(params, cfg, jnp.asarray(tokens),
                                            collect_cache=True)
    pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])  # noqa: E731
    jc = jax.tree.map(pad, jc)
    tc = bridge.from_numpy_tree(_np(jc))
    tok = np.asarray([[3], [7]], np.int32)
    jl, jnc = jtransformer.decoder_decode_step(params, cfg, jnp.asarray(tok), jc,
                                               jnp.int32(8))
    tl, tnc = transformer.decoder_decode_step(tparams, cfg, _t(tok), tc, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for (_, a), (_, b) in zip(tree_paths(_np(jnc)), tree_paths(tnc)):
        np.testing.assert_allclose(b.numpy(), a, rtol=CACHE_TOL, atol=CACHE_TOL)
    logits = rng.standard_normal((2, 8, cfg.vocab_size)).astype(np.float32)
    mask = (rng.random((2, 8)) > 0.3).astype(np.float32)
    for m in (None, mask):
        jloss = jtransformer.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        tloss = transformer.lm_loss(_t(logits), _t(labels), None if m is None else _t(m))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_has_the_reference_tree(dtype):
    cfg = j_get_config("tinyllama-1.1b", smoke=True).with_(param_dtype=dtype,
                                                           activation_dtype=dtype)
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
    batch = api.synth_batch(torch.Generator().manual_seed(0), cfg,
                            api.INPUT_SHAPES["train_4k"], "cpu")
    assert batch["tokens"].shape == batch["labels"].shape == (256, 4096)
    assert batch["tokens"].dtype == torch.int32
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < cfg.vocab_size


def test_decode_policy_and_decode_batch_match_reference():
    cfg = j_get_config("tinyllama-1.1b", smoke=True)
    for shape in api.INPUT_SHAPES.values():
        assert api.decode_window(cfg, shape.seq_len) == japi.decode_window(cfg, shape.seq_len)
        assert api.cache_length(cfg, shape.seq_len) == japi.cache_length(cfg, shape.seq_len)
        assert dataclasses.asdict(shape) == dataclasses.asdict(japi.INPUT_SHAPES[shape.name])
    shape = api.InputShape("decode", 24, 2, "decode")
    ref = japi.synth_batch(jax.random.key(0), cfg, japi.InputShape("decode", 24, 2, "decode"))
    got = api.synth_batch(torch.Generator().manual_seed(0), cfg, shape, "cpu")
    assert got["pos"] == int(ref["pos"]) == 23
    assert tuple(got["token"].shape) == ref["token"].shape and got["token"].dtype == torch.int32
    assert [(p, tuple(a.shape)) for p, a in tree_paths(got["cache"])] == \
        [(p, tuple(a.shape)) for p, a in tree_paths(ref["cache"])]
