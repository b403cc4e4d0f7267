"""The port's encoder-decoder (``models/encdec.py``, ``whisper-small``)
against the JAX package's.

On the smoke config in f32 with the reference's params
(``api.init(jax.random.key(seed))``) bridged:

* the port's own init has the reference's tree, shapes and dtypes (f32
  and bf16), and so has its decode cache (``self_k`` / ``self_v`` /
  ``cross_k`` / ``cross_v``); at full size the reference's 239,696,640
  params and its FedPart groups (``list_groups``);
* ``encode`` and ``api.forward`` (``impl="plain"`` and ``"kernel"``, the
  flash wrapper's plain version on the CPU): the encoder's output, logits
  and all four stacked caches; decoder positions past the ``dec_pos``
  table wrap as the reference's; ``api.loss``;
* ``impl="kernel"`` sends every attention of a forward to the flash
  wrapper (per layer the encoder's non-causal, the decoder's causal and
  the cross-attention non-causal over ``encoder_seq`` keys), ``"plain"``
  none;
* prefill, then one decode step, equal to the reference's full forward
  over one more token at that position (``tests/test_decode_consistency.py``);
* ``serve_session`` on the CPU: greedy tokens equal to a greedy loop over
  the reference's prefill / serve steps, every step's logits close; the
  cross caches are never grown;
* the frontends' specs and draws, and ``synth_batch``'s shapes and dtypes
  against the reference's.

Tolerances: logits, encoder output, loss and caches ≤ 1e-5 (abs + rel;
f32, sums in another order); decode against the forward 2e-4, the
reference's own test; serve logits 1e-4; tokens exact.
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
from repro.models import encdec as jencdec
from repro.models.api import InputShape
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve, steps
from repro_torch.models import api, encdec, frontends
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

ARCH = "whisper-small"
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
def model():
    """(ref cfg, ref params as numpy, bridged params)."""
    cfg = j_get_config(ARCH, smoke=True)
    params = _np(japi.init(jax.random.key(0), cfg))
    return cfg, params, bridge.from_numpy_tree(params)


def _batch(cfg, seed, s=16, b=2):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def test_config_is_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
    cfg = get_config(ARCH)
    assert (cfg.kind, cfg.resolved_head_dim, cfg.encoder_seq, cfg.use_rope) == \
        ("encdec", 64, 1500, False)


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
    assert all(str(b.dtype) == f"torch.{dtype}" for _, b in tcache)


def test_full_size_tree_and_groups():
    """At full size (shapes only, no storage): the reference's leaves and
    239,696,640 params, and its 26 FedPart groups."""
    cfg = get_config(ARCH)
    jtree = jax.eval_shape(lambda: japi.init(jax.random.key(0), cfg))
    meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), jtree)
    assert sum(x.numel() for _, x in tree_paths(meta)) == 239_696_640
    groups = [(g.key, g.index) for g in steps.list_groups(meta)]
    assert groups == [(g.key, g.index) for g in jsteps.list_groups(jtree)]
    assert groups == ([("embed", None)] + [("enc_blocks", i) for i in range(12)]
                      + [("dec_blocks", i) for i in range(12)]
                      + [("final_norm|enc_norm|enc_pos|dec_pos", None)])


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_encode_matches_reference(model, impl):
    cfg, params, tparams = model
    frames = _batch(cfg, 3)["frames"]
    want = jencdec.encode(params, cfg, frames)
    got = encdec.encode(tparams, cfg, torch.from_numpy(frames), impl=impl)
    assert tuple(got.shape) == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("s", [16, 70], ids=["s16", "s70-wraps"])
def test_forward_matches_reference(model, impl, s):
    """Logits and caches; at S 70 the decoder's positions pass the smoke
    ``dec_pos`` table (64) and wrap."""
    cfg, params, tparams = model
    batch = _batch(cfg, 5, s=s)
    jl, jc, jaux = japi.forward(params, cfg, batch, collect_cache=True)
    tl, tc, taux = api.forward(tparams, cfg, bridge.from_numpy_tree(batch), impl=impl,
                               collect_cache=True)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, s, cfg.vocab_size)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _close_tree(tc, jc)
    assert tuple(tc["cross_k"].shape) == (cfg.num_layers, 2, cfg.encoder_seq,
                                          cfg.num_kv_heads, cfg.resolved_head_dim)


def test_loss_matches_reference(model):
    cfg, params, tparams = model
    batch = _batch(cfg, 6)
    jl = japi.loss(params, cfg, batch)
    tl = api.loss(tparams, cfg, bridge.from_numpy_tree(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)


def test_kernel_impl_routes_every_attention(model, monkeypatch):
    """One flash call per attention: the encoder's layers non-causal, then
    each decoder layer's self (causal) and cross (non-causal, Skv the
    encoder's length); the plain impl makes none."""
    cfg, _, tparams = model
    calls = []
    real = fa_ops.flash_attention

    def counting(q, k, v, *, causal=True, window=0):
        calls.append((causal, q.shape[1], k.shape[1]))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fa_ops, "flash_attention", counting)
    batch = bridge.from_numpy_tree(_batch(cfg, 7))
    api.forward(tparams, cfg, batch, impl="plain")
    assert calls == []
    api.forward(tparams, cfg, batch, impl="kernel")
    t = cfg.encoder_seq
    assert calls == [(False, t, t)] * cfg.encoder_layers + \
        [(True, 16, 16), (False, 16, t)] * cfg.num_layers


def test_prefill_then_decode_matches_forward(model):
    """The reference's decode-consistency test with the port's decode: the
    reference's forward over S + 1 tokens at position S, and the port's
    prefill + one decode step (the self cache grown, the cross cache not)."""
    cfg, params, tparams = model
    s = PROMPT
    batch = japi.synth_batch(jax.random.key(1), cfg, InputShape("p", s, BATCH, "prefill"))
    logits_s, _, _ = japi.forward(params, cfg, batch)
    next_tok = jnp.argmax(logits_s[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    ref_logits, _, _ = japi.forward(
        params, cfg, {"tokens": jnp.concatenate([batch["tokens"], next_tok], axis=1),
                      "frames": batch["frames"]})
    with torch.inference_mode():
        _, cache = steps.make_prefill_step(cfg)(tparams, bridge.from_numpy_tree(_np(batch)))
        cache = serve._grow_attention_caches(cache, s, s + 1)
        assert cache["self_k"].shape[2] == s + 1
        assert cache["cross_k"].shape[2] == cfg.encoder_seq
        got, out = api.decode_step(tparams, cfg, bridge.from_numpy_tree(
            {"t": np.asarray(next_tok)})["t"], cache, s)
    assert out["self_k"] is cache["self_k"]   # written in place
    np.testing.assert_allclose(got[:, 0, :].numpy(), np.asarray(ref_logits[:, -1, :]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_grow_leaves_cross_caches_alone():
    """At a prompt as long as the encoder (12 frames at smoke size) only the
    self caches grow, as the reference's names say."""
    cfg = get_config(ARCH, smoke=True)
    cache = api.cache_init(cfg, 2, cfg.encoder_seq, torch.float32, "cpu")
    grown = serve._grow_attention_caches(cache, cfg.encoder_seq, cfg.encoder_seq + 3)
    assert grown["self_v"].shape[2] == cfg.encoder_seq + 3
    assert grown["cross_v"] is cache["cross_v"] and grown["cross_k"] is cache["cross_k"]


@pytest.fixture(scope="module")
def reference_serve():
    """The reference's params, prompt (tokens and frames) and greedy run with
    every step's logits (its ``serve_session``'s loop, unrolled to keep
    them)."""
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
                       "--prompt-len", "10", "--gen", "3"]) == 0
    assert "[serve] prefill 2x10" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontends_and_synth_batch(dtype):
    cfg = get_config(ARCH, smoke=True).with_(param_dtype=dtype, activation_dtype=dtype)
    spec = frontends.frame_embeds_spec(cfg, 3)
    assert spec.device.type == "meta" and tuple(spec.shape) == (3, cfg.encoder_seq, cfg.d_model)
    assert spec.dtype == getattr(torch, dtype)
    a = frontends.synth_frame_embeds(torch.Generator().manual_seed(4), cfg, 3, "cpu")
    b = frontends.synth_frame_embeds(torch.Generator().manual_seed(4), cfg, 3, "cpu")
    assert torch.equal(a, b) and a.dtype == spec.dtype and a.shape == spec.shape
    assert 0.8 < float(a.float().std()) < 1.2
    for name, shape in api.INPUT_SHAPES.items():
        small = InputShape(name, 24, 2, shape.kind)
        want = jax.eval_shape(lambda: japi.synth_batch(jax.random.key(0), cfg, small))
        got = api.synth_batch(torch.Generator().manual_seed(0), cfg, small, "cpu")
        assert sorted(got) == sorted(want)
        if shape.kind == "decode":
            assert got["pos"] == 23
            got, want = got["cache"], want["cache"]
        wflat, gflat = tree_paths(want), tree_paths(got)
        assert [(p, tuple(x.shape), str(x.dtype)) for p, x in wflat] == \
            [(p, tuple(x.shape), str(x.dtype)[6:]) for p, x in gflat]
