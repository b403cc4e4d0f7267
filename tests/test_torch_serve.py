"""The port's serving driver against the JAX package's, on ``tinyllama-1.1b``
smoke in f32 on the CPU.

``serve_session`` gets the reference's params and prompt (``api.init(key)``,
``api.synth_batch(fold_in(key, 1), ...)``, as the reference's own
``serve_session`` draws them), bridged.  Its greedy tokens must equal the
reference's ``serve_session``'s, and its per-step logits must match the
reference's prefill / serve steps with ``_grow_attention_caches`` between
them, for both prefill attention implementations.

Tolerance: logits ≤ 1e-4 (f32, sums in another order); tokens exact.
"""

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
from repro_torch.launch import serve
from repro_torch.tree import tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

LOGIT_TOL = 1e-4
BATCH, PROMPT, GEN, SEED = 2, 16, 6, 0


@pytest.fixture(scope="module")
def reference():
    """The reference's params, prompt, and its greedy run with every step's
    logits (its ``serve_session``'s loop, unrolled here to keep them)."""
    cfg = j_get_config("tinyllama-1.1b", smoke=True)
    key = jax.random.key(SEED)
    params = japi.init(key, cfg)
    prompt = japi.synth_batch(jax.random.fold_in(key, 1), cfg,
                              InputShape("serve", PROMPT, BATCH, "prefill"))
    prefill = jax.jit(jsteps.make_prefill_step(cfg))
    step = jax.jit(jsteps.make_serve_step(cfg))
    logits, cache = prefill(params, prompt)
    cache = jserve._grow_attention_caches(cache, PROMPT, PROMPT + GEN)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    toks, all_logits = [tok], [logits]
    for i in range(GEN - 1):
        logits, cache = step(params, tok, cache, jnp.int32(PROMPT + i))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
        all_logits.append(logits)
    return {"cfg": cfg, "params": jax.tree.map(np.asarray, params),
            "prompt": jax.tree.map(np.asarray, prompt),
            "tokens": np.asarray(jnp.concatenate(toks, axis=1)),
            "logits": [np.asarray(x) for x in all_logits]}


def test_reference_loop_is_the_reference_serve_session(reference):
    out = jserve.serve_session(reference["cfg"], BATCH, PROMPT, GEN, seed=SEED,
                               verbose=False)
    np.testing.assert_array_equal(np.asarray(out), reference["tokens"])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_serve_session_matches_reference(reference, impl):
    res = serve.serve_session(
        reference["cfg"], BATCH, PROMPT, GEN, device="cpu", impl=impl,
        params=bridge.from_numpy_tree(reference["params"]),
        prompt=bridge.from_numpy_tree(reference["prompt"]), verbose=False)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (BATCH, GEN)
    np.testing.assert_array_equal(res.tokens.numpy(), reference["tokens"])
    assert len(res.logits) == GEN
    for i, (t, j) in enumerate(zip(res.logits, reference["logits"])):
        assert tuple(t.shape) == j.shape == (BATCH, 1, reference["cfg"].vocab_size)
        np.testing.assert_allclose(t.numpy(), j, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
    assert res.prefill_seconds > 0 and res.decode_seconds > 0


def test_grow_attention_caches_matches_reference():
    rng = np.random.default_rng(0)
    cache = {"blocks": {"k": rng.standard_normal((2, 3, 5, 2, 4)).astype(np.float32),
                        "v": rng.standard_normal((2, 3, 5, 2, 4)).astype(np.float32)},
             "state": rng.standard_normal((2, 3, 5, 2)).astype(np.float32)}
    ref = jax.tree.map(np.asarray, jserve._grow_attention_caches(cache, 5, 9))
    got = serve._grow_attention_caches(bridge.from_numpy_tree(cache), 5, 9)
    assert [p for p, _ in tree_paths(ref)] == [p for p, _ in tree_paths(got)]
    for (path, a), (_, b) in zip(tree_paths(ref), tree_paths(got)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg="/".join(path))


def test_serve_session_draws_its_own_weights_on_the_cpu():
    cfg = j_get_config("tinyllama-1.1b", smoke=True).with_(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    a = serve.serve_session(cfg, 2, 8, 3, seed=1, device="cpu", verbose=False)
    b = serve.serve_session(cfg, 2, 8, 3, seed=1, device="cpu", verbose=False)
    assert torch.equal(a.tokens, b.tokens)
    assert all(bool(torch.isfinite(x).all()) for x in a.logits)
    assert all(x.dtype == torch.float32 for x in a.logits)


def test_main_runs_on_the_cpu(capsys):
    assert serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen", "3"]) == 0
    assert "[serve] prefill 2x8" in capsys.readouterr().out


def test_main_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "2"])
