"""The port's MoE decoders against the JAX package's: ``llama4-maverick-
400b-a17b`` (GQA 40 / 8 at full size, MoE top-1 with a shared expert, every
layer MoE) and ``deepseek-v3-671b`` (MLA, sigmoid top-8 with a shared
expert, leading dense blocks, the MTP head).

On the smoke configs in f32 with the reference's params
(``api.init(jax.random.key(seed))``) bridged, and DeepSeek also with
``with_(mtp_depth=1)`` in both packages:

* the configs equal the reference's, full and smoke; whisper-small and
  llava-next-34b still raise naming ROADMAP item 15;
* the port's own init has the reference's tree, shapes and dtypes (f32
  and bf16), and so has its decode cache (MLA's latent ``c_kv`` /
  ``k_rope``);
* ``api.forward`` (``impl="plain"`` and ``"kernel"``): logits, the aux
  loss and the stacked caches; ``api.loss``, the MTP head's weighted loss
  included;
* prefill, then one decode step, equal to the reference's full forward
  over one more token at that position (``tests/test_decode_consistency.py``);
  and Llama-4 at ``capacity_factor`` 1.25, where a decode step of B 4 has
  one slot an expert and drops tokens as the reference does;
* ``serve_session`` on the CPU: greedy tokens equal to a greedy loop over
  the reference's prefill / serve steps, every step's logits close;
* bf16 trees cross the bridge bit for bit.

Tolerances: logits, aux, loss and caches ≤ 1e-5 (abs + rel; f32, sums in
another order); decode against the forward 2e-4, the reference's own test;
serve logits 1e-4 as ``tests/test_torch_dense_archs.py``; tokens exact.
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
from repro.models.api import InputShape
from repro_torch import bridge
from repro_torch.configs import available_archs, get_config
from repro_torch.launch import serve
from repro_torch.models import api, moe
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v3-671b"]
# (arch, config overrides): DeepSeek also with its MTP head, which smoke drops
MODELS = [("llama4-maverick-400b-a17b", {}), ("deepseek-v3-671b", {}),
          ("deepseek-v3-671b", {"mtp_depth": 1})]
MODEL_IDS = ["llama4", "deepseek", "deepseek-mtp"]
TOL = 1e-5
DECODE_TOL = 2e-4
LOGIT_TOL = 1e-4
BATCH, PROMPT, GEN = 2, 12, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, tol=TOL):
    wflat, gflat = tree_paths(_np(want)), tree_paths(got)
    assert [p for p, _ in wflat] == [p for p, _ in gflat]
    for (path, a), (_, b) in zip(wflat, gflat):
        assert tuple(a.shape) == tuple(b.shape), path
        np.testing.assert_allclose(b.numpy(), a, rtol=tol, atol=tol, err_msg="/".join(path))


@pytest.fixture(scope="module")
def models():
    """(ref cfg, ref params as numpy, bridged params) per ``MODELS`` entry."""
    out = {}
    for (arch, kw), name in zip(MODELS, MODEL_IDS):
        cfg = j_get_config(arch, smoke=True).with_(**kw)
        params = _np(japi.init(jax.random.key(0), cfg))
        out[name] = (cfg, params, bridge.from_numpy_tree(params))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(arch, smoke=smoke))
    assert arch in available_archs()
    for name in ("whisper-small", "llava-next-34b"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 15"):
            get_config(name)


def test_full_sizes_are_the_served_ones():
    """Llama-4's GQA group of 5 at head dim 128; DeepSeek's MLA widths."""
    l4 = get_config("llama4-maverick-400b-a17b")
    assert (l4.num_heads // l4.num_kv_heads, l4.resolved_head_dim, l4.use_mla) == (5, 128, False)
    ds = get_config("deepseek-v3-671b")
    assert (ds.use_mla, ds.qk_nope_head_dim + ds.qk_rope_head_dim, ds.v_head_dim) == \
        (True, 192, 128)
    assert (ds.first_dense_layers, ds.mtp_depth, ds.num_experts_per_tok) == (3, 1, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", MODELS, ids=MODEL_IDS)
def test_port_init_has_the_reference_tree(arch, kw, dtype):
    cfg = j_get_config(arch, smoke=True).with_(param_dtype=dtype, activation_dtype=dtype,
                                               **kw)
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


def _batch(cfg, seed, s=16):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("name", MODEL_IDS)
def test_forward_matches_reference(models, name, impl):
    cfg, params, tparams = models[name]
    batch = _batch(cfg, 5)
    jl, jc, jaux = japi.forward(params, cfg, batch, collect_cache=True)
    tl, tc, taux = api.forward(tparams, cfg, bridge.from_numpy_tree(batch), impl=impl,
                               collect_cache=True)
    assert tl.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)
    _close_tree(tc, jc)


@pytest.mark.parametrize("name", MODEL_IDS)
def test_loss_matches_reference(models, name):
    cfg, params, tparams = models[name]
    batch = _batch(cfg, 6)
    jl = japi.loss(params, cfg, batch)
    tl = api.loss(tparams, cfg, bridge.from_numpy_tree(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    # the MTP head adds its weighted loss only where it exists and labels are given
    _, _, aux = api.forward(tparams, cfg, bridge.from_numpy_tree({"tokens": batch["tokens"]}),
                            impl="plain")
    _, _, aux_l = api.forward(tparams, cfg, bridge.from_numpy_tree(batch), impl="plain")
    assert (float(aux_l) > float(aux) + 1.0) == (cfg.mtp_depth > 0)


def _decode_against_forward(cfg, params, tparams):
    """The reference's decode-consistency test with the port's decode: the
    reference's forward over S + 1 tokens at position S, and the port's
    prefill + one decode step."""
    s = PROMPT
    batch = japi.synth_batch(jax.random.key(1), cfg, InputShape("p", s, BATCH, "prefill"))
    logits_s, _, _ = japi.forward(params, cfg, batch)
    next_tok = jnp.argmax(logits_s[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    ref_logits, _, _ = japi.forward(
        params, cfg, {"tokens": jnp.concatenate([batch["tokens"], next_tok], axis=1)})
    prefill = serve.steps.make_prefill_step(cfg)
    with torch.inference_mode():
        _, cache = prefill(tparams, bridge.from_numpy_tree(_np(batch)))
        cache = serve._grow_attention_caches(cache, s, s + 1)
        got, _ = api.decode_step(tparams, cfg, bridge.from_numpy_tree(
            {"t": np.asarray(next_tok)})["t"], cache, s)
    return got[:, 0, :].numpy(), np.asarray(ref_logits[:, -1, :])


@pytest.mark.parametrize("name", ["llama4", "deepseek"])
def test_prefill_then_decode_matches_forward(models, name):
    got, want = _decode_against_forward(*models[name])
    np.testing.assert_allclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)


def test_decode_drops_tokens_as_the_reference_does(monkeypatch):
    """Llama-4 smoke at the full config's ``capacity_factor`` 1.25: a decode
    step of B 4 over 4 experts has one slot an expert, so tokens routed to a
    busy expert are dropped; the port's step equals the reference's."""
    cfg = j_get_config("llama4-maverick-400b-a17b", smoke=True).with_(capacity_factor=1.25)
    params = _np(japi.init(jax.random.key(2), cfg))
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    cache = _np(japi.cache_init(cfg, 4, 6, jnp.float32))
    jl, jc = japi.decode_step(params, cfg, tok, cache, jnp.int32(0))
    routes = []
    real_route = moe.route

    def recording_route(*args):
        out = real_route(*args)
        routes.append(out[2])
        return out

    monkeypatch.setattr(moe, "route", recording_route)
    tl, tc = api.decode_step(bridge.from_numpy_tree(params), cfg,
                             bridge.from_numpy_tree({"t": tok})["t"],
                             bridge.from_numpy_tree(cache), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _close_tree(tc, jc)
    # the drops are real: in some layer two of the four tokens share an expert
    assert moe._capacity(4, cfg) == 1 and len(routes) == cfg.num_layers
    assert any(len(set(r[:, 0].tolist())) < 4 for r in routes)


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


@pytest.mark.parametrize("arch,kw", MODELS, ids=MODEL_IDS)
def test_bf16_round_trip_is_bit_exact(arch, kw):
    cfg = j_get_config(arch, smoke=True).with_(param_dtype="bfloat16", **kw)
    ref = _np(japi.init(jax.random.key(0), cfg))
    tree = bridge.from_numpy_tree(ref, "cpu")
    back = bridge.to_numpy_tree(tree)
    ref_flat, back_flat = tree_paths(ref), tree_paths(back)
    assert [p for p, _ in ref_flat] == [p for p, _ in back_flat]
    for (path, a), (_, t), (_, b) in zip(ref_flat, tree_paths(tree), back_flat):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16, path
        assert b.dtype == a.dtype and b.shape == a.shape, path
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16)), path
