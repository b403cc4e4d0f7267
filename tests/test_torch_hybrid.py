"""The port's Zamba2 hybrid against the JAX package's, on bridged
``zamba2-7b`` smoke params in f32 on the CPU.

* configs: the port's ``zamba2-7b`` equals the reference's, field for field,
  and so does ``whisper-small``; a model kind neither package knows raises
  ``ValueError`` in both;
* ``hybrid_forward`` logits and stacked caches (``impl="kernel"``, which on
  the CPU runs the kernels' plain versions, and ``impl="plain"``) against
  the reference's ``impl="xla"`` forward; ``hybrid_decode_step`` against
  the reference's, from the same grown cache;
* prefill-then-decode consistency (S 12, a ragged scan chunk of 12),
  mirroring ``tests/test_decode_consistency.py``'s zamba2 case, which the
  reference runs only in its slow lane;
* ``serve_session``: greedy tokens identical to the reference's
  ``serve_session`` on the same params and prompt; ``_grow_attention_caches``
  on the hybrid's cache tree; the CLI on the CPU; a prompt that is not a
  multiple of the scan chunk raises, as the reference asserts;
* the port's own init has the reference's tree, shapes and dtypes.

Tolerances: logits ≤ 1e-4 and caches ≤ 1e-5 (f32, sums in another order);
prefill-then-decode ≤ 2e-4, the reference's own; tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models.api import InputShape
from repro_torch import bridge
from repro_torch.configs import available_archs, get_config
from repro_torch.launch import serve
from repro_torch.models import api, transformer
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
CONSISTENCY_TOL = 2e-4
BATCH, PROMPT, GEN, SEED = 2, 32, 5, 0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, tol: float) -> None:
    want = _np(want)
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        assert a.dtype == getattr(torch, b.dtype.name) and tuple(a.shape) == b.shape, path
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=tol, atol=tol, err_msg="/".join(path))


@pytest.fixture(scope="module")
def reference():
    """The reference's params and prompt (as its ``serve_session`` draws
    them), its forward with caches, and one decode step from the grown
    cache."""
    cfg = j_get_config("zamba2-7b", smoke=True)
    key = jax.random.key(SEED)
    params = japi.init(key, cfg)
    prompt = japi.synth_batch(jax.random.fold_in(key, 1), cfg,
                              InputShape("serve", PROMPT, BATCH, "prefill"))
    fwd = jax.jit(lambda p, b: japi.forward(p, cfg, b, collect_cache=True))
    logits, cache, _ = fwd(params, prompt)
    grown = jserve._grow_attention_caches(cache, PROMPT, PROMPT + GEN)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    step = jax.jit(lambda p, t, c, i: japi.decode_step(p, cfg, t, c, i))
    dec_logits, dec_cache = step(params, tok, grown, jnp.int32(PROMPT))
    return {"cfg": cfg, "params": _np(params), "prompt": _np(prompt),
            "logits": np.asarray(logits), "cache": _np(cache), "grown": _np(grown),
            "token": np.asarray(tok), "dec_logits": np.asarray(dec_logits),
            "dec_cache": _np(dec_cache)}


def test_configs_equal_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(j_get_config("zamba2-7b", smoke=smoke)) == \
            dataclasses.asdict(get_config("zamba2-7b", smoke=smoke))
    assert "zamba2-7b" in available_archs()
    assert dataclasses.asdict(get_config("whisper-small")) == \
        dataclasses.asdict(j_get_config("whisper-small"))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_hybrid_forward_matches_reference(reference, impl):
    cfg = reference["cfg"]
    logits, cache, aux = api.forward(bridge.from_numpy_tree(reference["params"]), cfg,
                                     bridge.from_numpy_tree(reference["prompt"]),
                                     impl=impl, collect_cache=True)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), reference["logits"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _close_tree(cache, reference["cache"], CACHE_TOL)
    n_chunks, tail = transformer.hybrid_layout(cfg)
    assert cache["chunks"]["attn_kv"]["k"].shape[:3] == (n_chunks, BATCH, PROMPT)
    assert cache["chunks"]["mamba"]["state"].shape[:2] == (n_chunks, cfg.attn_every)
    assert cache["tail"]["conv"].shape[0] == tail == 1


def test_hybrid_decode_step_matches_reference(reference):
    cfg = reference["cfg"]
    cache = bridge.from_numpy_tree(reference["grown"])
    logits, new = api.decode_step(bridge.from_numpy_tree(reference["params"]), cfg,
                                  torch.tensor(reference["token"]), cache, PROMPT)
    assert new is cache     # written in place
    np.testing.assert_allclose(logits.numpy(), reference["dec_logits"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _close_tree(new, reference["dec_cache"], CACHE_TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_then_decode_matches_forward(reference, impl):
    """S 12 with the smoke chunk of 16: one ragged scan chunk of 12 (13 in
    the S + 1 forward)."""
    cfg, s = reference["cfg"], 12
    params = bridge.from_numpy_tree(reference["params"])
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, s), dtype=np.int32))
    logits_s, cache, _ = api.forward(params, cfg, {"tokens": tokens}, impl=impl,
                                     collect_cache=True)
    nxt = torch.argmax(logits_s[:, -1, :], dim=-1)[:, None].to(torch.int32)
    want, _, _ = api.forward(params, cfg, {"tokens": torch.cat([tokens, nxt], dim=1)},
                             impl=impl)
    cache = serve._grow_attention_caches(cache, s, s + 1)
    got, _ = api.decode_step(params, cfg, nxt, cache, s)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, -1].numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_serve_session_matches_reference(reference, impl):
    want = jserve.serve_session(reference["cfg"], BATCH, PROMPT, GEN, seed=SEED,
                                verbose=False)
    res = serve.serve_session(
        reference["cfg"], BATCH, PROMPT, GEN, device="cpu", impl=impl,
        params=bridge.from_numpy_tree(reference["params"]),
        prompt=bridge.from_numpy_tree(reference["prompt"]), verbose=False)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want))
    np.testing.assert_allclose(res.logits[0].numpy(), reference["logits"][:, -1:],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(res.logits[1].numpy(), reference["dec_logits"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_grow_attention_caches_matches_reference(reference):
    """Only ``chunks/attn_kv/{k,v}`` grow (sequence on axis 2); the Mamba2
    ``state`` and ``conv`` leaves are untouched."""
    got = serve._grow_attention_caches(bridge.from_numpy_tree(reference["cache"]),
                                       PROMPT, PROMPT + GEN)
    _close_tree(got, reference["grown"], 0.0)
    assert got["chunks"]["attn_kv"]["v"].shape[2] == PROMPT + GEN


def test_prompt_not_a_multiple_of_the_chunk_raises(reference):
    cfg = reference["cfg"]
    params = bridge.from_numpy_tree(reference["params"])
    with pytest.raises(ValueError, match="not divisible"):
        serve.serve_session(cfg, 1, 20, 2, device="cpu", params=params, verbose=False)
    with pytest.raises(AssertionError, match="not divisible"):
        serve.serve_session(cfg, 1, 20, 2, device="cpu", params=params, impl="plain",
                            verbose=False)


def test_port_init_matches_reference_tree():
    """The port's own init and cache: the reference's paths, shapes and
    dtypes (bf16 leaves beside the f32 ``a_log`` / ``dt_bias``)."""
    cfg = j_get_config("zamba2-7b", smoke=True).with_(param_dtype="bfloat16",
                                                       activation_dtype="bfloat16")
    want = jax.eval_shape(lambda: japi.init(jax.random.key(0), cfg))
    got = api.init(torch.Generator().manual_seed(0), cfg, "cpu")
    want_c = jax.eval_shape(lambda: japi.cache_init(cfg, 2, 40, jnp.bfloat16))
    got_c = api.cache_init(cfg, 2, 40, torch.bfloat16, "cpu")
    for g, w in ((got, want), (got_c, want_c)):
        assert [p for p, _ in tree_paths(g)] == [p for p, _ in tree_paths(w)]
        for (path, a), (_, b) in zip(tree_paths(g), tree_paths(w)):
            assert tuple(a.shape) == b.shape, path
            assert a.dtype == getattr(torch, b.dtype.name), path
    assert not any(bool(x.any()) for _, x in tree_paths(got_c))


def test_serve_draws_its_own_weights_and_runs_from_the_cli(capsys):
    cfg = get_config("zamba2-7b", smoke=True)
    a = serve.serve_session(cfg, 2, 16, 3, seed=1, device="cpu", verbose=False)
    b = serve.serve_session(cfg, 2, 16, 3, seed=1, device="cpu", verbose=False)
    assert torch.equal(a.tokens, b.tokens)
    assert all(bool(torch.isfinite(x).all()) for x in a.logits)
    assert serve.main(["--arch", "zamba2-7b", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "16", "--gen", "3"]) == 0
    assert "[serve] prefill 2x16" in capsys.readouterr().out


def test_unported_kinds_still_raise():
    """Every kind the reference runs is ported; a kind neither package knows
    raises ``ValueError`` from each dispatch in both."""
    cfg = j_get_config("whisper-small", smoke=True).with_(kind="seq2seq")
    tok = np.zeros((1, 1), np.int32)
    for call in (lambda: api.init(torch.Generator(), cfg, "cpu"),
                 lambda: api.cache_init(cfg, 1, 4, torch.float32, "cpu"),
                 lambda: api.forward({}, cfg, {"tokens": torch.from_numpy(tok)}),
                 lambda: api.decode_step({}, cfg, torch.from_numpy(tok), {}, 0),
                 lambda: japi.init(jax.random.key(0), cfg),
                 lambda: japi.cache_init(cfg, 1, 4, jnp.float32),
                 lambda: japi.forward({}, cfg, {"tokens": tok}),
                 lambda: japi.decode_step({}, cfg, tok, {}, jnp.int32(0))):
        with pytest.raises(ValueError):
            call()
