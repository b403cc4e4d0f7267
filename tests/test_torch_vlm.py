"""The port's VLM (``llava-next-34b``: a dense GQA decoder whose sequence
starts with the stub vision tower's media embeddings) against the JAX
package's.

On the smoke config in f32 (8 media positions, GQA 4 / 2) with the
reference's params (``api.init(jax.random.key(seed))``) bridged:

* the configs equal the reference's; at full size the reference's
  34,388,917,248 params, a GQA group of 7 at head dim 128;
* the port's own init has the reference's tree, shapes and dtypes (f32 and
  bf16), and so has its decode cache;
* ``api.forward`` (``impl="plain"`` and ``"kernel"``) with the media
  prefix: logits over media + text positions and the stacked caches;
  ``api.loss`` over the text positions only (the media logits carry no
  labels: changing them leaves the loss as it was);
* ``impl="kernel"`` makes one causal flash call per layer over media +
  tokens;
* prefill, then one decode step at position S = media + tokens, equal to
  the reference's full forward over one more token
  (``tests/test_decode_consistency.py``);
* ``serve_session`` on the CPU with ``prompt_len`` counting the media:
  greedy tokens equal to a greedy loop over the reference's steps, every
  step's logits close;
* the frontends' specs and draws, and ``synth_batch``'s shapes and dtypes
  (``S - num_media_tokens`` tokens) against the reference's.

Tolerances: logits, loss and caches ≤ 1e-5 (abs + rel; f32, sums in
another order); decode against the forward 2e-4, the reference's own test;
serve logits 1e-4; tokens exact.
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
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve, steps
from repro_torch.models import api, frontends, transformer
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

ARCH = "llava-next-34b"
TOL = 1e-5
DECODE_TOL = 2e-4
LOGIT_TOL = 1e-4
BATCH, PROMPT, GEN = 2, 20, 4      # PROMPT counts the 8 smoke media positions


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, tol=TOL):
    wflat, gflat = tree_paths(_np(want)), tree_paths(got)
    assert [p for p, _ in wflat] == [p for p, _ in gflat]
    for (path, a), (_, b) in zip(wflat, gflat):
        assert tuple(a.shape) == tuple(b.shape), path
        np.testing.assert_allclose(b.numpy(), a, rtol=tol, atol=tol, err_msg="/".join(path))


@pytest.fixture(scope="module")
def model():
    """(ref cfg, ref params as numpy, bridged params)."""
    cfg = j_get_config(ARCH, smoke=True)
    params = _np(japi.init(jax.random.key(0), cfg))
    return cfg, params, bridge.from_numpy_tree(params)


def _batch(cfg, seed, s=16, b=2):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["media"] = rng.standard_normal(
        (b, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return batch


def test_config_is_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
    cfg = get_config(ARCH)
    assert (cfg.kind, cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.num_media_tokens) == ("decoder", 7, 128, 576)
    jtree = jax.eval_shape(lambda: japi.init(jax.random.key(0), cfg))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree)) == 34_388_917_248


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_has_the_reference_tree(dtype):
    cfg = j_get_config(ARCH, smoke=True).with_(param_dtype=dtype, activation_dtype=dtype)
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


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_forward_matches_reference(model, impl):
    cfg, params, tparams = model
    batch = _batch(cfg, 5)
    jl, jc, _ = japi.forward(params, cfg, batch, collect_cache=True)
    tl, tc, taux = api.forward(tparams, cfg, bridge.from_numpy_tree(batch), impl=impl,
                               collect_cache=True)
    assert tuple(tl.shape) == (2, cfg.num_media_tokens + 16, cfg.vocab_size)
    assert float(taux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _close_tree(tc, jc)


def test_loss_scores_text_positions_only(model, monkeypatch):
    cfg, params, tparams = model
    batch = _batch(cfg, 6)
    jl = japi.loss(params, cfg, batch)
    tb = bridge.from_numpy_tree(batch)
    tl = api.loss(tparams, cfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)

    # the media positions' logits do not enter the loss
    real = transformer.decoder_forward

    def media_logits_scrambled(*args, **kw):
        logits, cache, aux = real(*args, **kw)
        logits = logits.clone()
        logits[:, :cfg.num_media_tokens] = 1e3
        return logits, cache, aux

    monkeypatch.setattr(transformer, "decoder_forward", media_logits_scrambled)
    assert float(api.loss(tparams, cfg, tb)) == float(tl)


def test_kernel_impl_launches_once_a_layer(model, monkeypatch):
    cfg, _, tparams = model
    calls = []
    real = fa_ops.flash_attention

    def counting(q, k, v, *, causal=True, window=0):
        calls.append((causal, q.shape[1], k.shape[1], q.shape[2], k.shape[2]))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fa_ops, "flash_attention", counting)
    batch = bridge.from_numpy_tree(_batch(cfg, 7))
    api.forward(tparams, cfg, batch, impl="plain")
    assert calls == []
    api.forward(tparams, cfg, batch, impl="kernel")
    s = cfg.num_media_tokens + 16
    assert calls == [(True, s, s, cfg.num_heads, cfg.num_kv_heads)] * cfg.num_layers


def test_prefill_then_decode_matches_forward(model):
    """Decode at position S = media + tokens against the reference's forward
    over one more token behind the same media."""
    cfg, params, tparams = model
    s = PROMPT
    batch = japi.synth_batch(jax.random.key(1), cfg, InputShape("p", s, BATCH, "prefill"))
    assert batch["tokens"].shape == (BATCH, s - cfg.num_media_tokens)
    logits_s, _, _ = japi.forward(params, cfg, batch)
    next_tok = jnp.argmax(logits_s[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    ref_logits, _, _ = japi.forward(
        params, cfg, {"tokens": jnp.concatenate([batch["tokens"], next_tok], axis=1),
                      "media": batch["media"]})
    with torch.inference_mode():
        _, cache = steps.make_prefill_step(cfg)(tparams, bridge.from_numpy_tree(_np(batch)))
        assert cache["blocks"]["k"].shape[2] == s
        cache = serve._grow_attention_caches(cache, s, s + 1)
        got, _ = api.decode_step(tparams, cfg, bridge.from_numpy_tree(
            {"t": np.asarray(next_tok)})["t"], cache, s)
    np.testing.assert_allclose(got[:, 0, :].numpy(), np.asarray(ref_logits[:, -1, :]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.fixture(scope="module")
def reference_serve():
    """The reference's params, prompt (media and tokens) and greedy run with
    every step's logits (its ``serve_session``'s loop, unrolled)."""
    cfg = j_get_config(ARCH, smoke=True)
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
    return {"cfg": cfg, "params": _np(params), "prompt": _np(prompt),
            "tokens": np.asarray(jnp.concatenate(toks, axis=1)),
            "logits": [np.asarray(x) for x in all_logits]}


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_serve_session_matches_reference(reference_serve, impl):
    ref = reference_serve
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


def test_serve_cli_runs(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "14", "--gen", "3"]) == 0
    assert "[serve] prefill 2x14" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontends_and_synth_batch(dtype):
    cfg = get_config(ARCH, smoke=True).with_(param_dtype=dtype, activation_dtype=dtype)
    spec = frontends.media_embeds_spec(cfg, 3)
    assert spec.device.type == "meta"
    assert tuple(spec.shape) == (3, cfg.num_media_tokens, cfg.d_model)
    assert spec.dtype == getattr(torch, dtype)
    a = frontends.synth_media_embeds(torch.Generator().manual_seed(4), cfg, 3, "cpu")
    b = frontends.synth_media_embeds(torch.Generator().manual_seed(4), cfg, 3, "cpu")
    assert torch.equal(a, b) and a.dtype == spec.dtype and a.shape == spec.shape
    for name, shape in api.INPUT_SHAPES.items():
        small = InputShape(name, 24, 2, shape.kind)
        want = jax.eval_shape(lambda: japi.synth_batch(jax.random.key(0), cfg, small))
        got = api.synth_batch(torch.Generator().manual_seed(0), cfg, small, "cpu")
        assert sorted(got) == sorted(want)
        if shape.kind == "decode":
            assert got["pos"] == 23
            got, want = got["cache"], want["cache"]
        else:
            assert tuple(got["tokens"].shape) == (2, 24 - cfg.num_media_tokens)
        wflat, gflat = tree_paths(want), tree_paths(got)
        assert [(p, tuple(x.shape), str(x.dtype)) for p, x in wflat] == \
            [(p, tuple(x.shape), str(x.dtype)[6:]) for p, x in gflat]
