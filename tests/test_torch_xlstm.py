"""The port's xLSTM (``xlstm-125m``: mLSTM / sLSTM pairs) against the JAX
package's, on bridged smoke params in f32 on the CPU.

* the port's own init at full size has the reference's tree, shapes and
  dtypes (162,391,392 parameters in 20 leaves), and its cache the
  reference's tuple ``(c, n, h, m)`` with m in f32 (the config itself is
  held field by field in ``test_torch_configs.py``);
* the blocks: ``mlstm_forward`` (``impl="kernel"``, which on the CPU runs
  the SSD kernel's plain version, and ``impl="plain"``), ``mlstm_decode``,
  ``slstm_forward`` and ``slstm_decode`` against the reference's;
* ``api.forward`` with caches, ``api.decode_step`` (in place), and
  prefill-then-3-decode-steps consistency with the forward (S 12, a
  ragged scan chunk), for both ``impl``s; a bf16 forward whose caches keep
  the reference's mixed dtypes through the bridge;
* ``serve_session``: greedy tokens identical to the reference's on the
  same params and prompt; the CLI on the CPU;
* the trees walk tuples as ``jax.tree.flatten`` does (the sLSTM cache),
  keep lists and named tuples as leaves, and leave the masked-Adam pack
  layouts of ResNet-8 and the nlp transformer as the reference's.

Tolerances: logits ≤ 1e-4 and caches ≤ 1e-5 (f32, sums in another order);
block outputs ≤ 1e-4; prefill-then-decode ≤ 2e-4, the reference's own;
bf16 ≤ 5e-2 abs + rel (one bf16 ulp is 2^-8, rounded at several ops on
both sides); tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.fl import nlp_task as j_nlp_task
from repro.fl.tasks import resnet_task as j_resnet_task
from repro.kernels.masked_adam import ops as j_pack
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.models.api import InputShape
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.fl import nlp_task
from repro_torch.kernels.masked_adam import ops as pack_ops
from repro_torch.launch import serve
from repro_torch.models import api, ssm
from repro_torch.optim.adam import AdamState
from repro_torch.tree import tree_from_paths, tree_leaves, tree_map, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
OUT_TOL = 1e-4
CONSISTENCY_TOL = 2e-4
BF16_TOL = 5e-2
BATCH, PROMPT, GEN, SEED = 2, 32, 5, 0
ARCH = "xlstm-125m"


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
    them), its forward with caches, and one decode step from that cache."""
    cfg = j_get_config(ARCH, smoke=True)
    key = jax.random.key(SEED)
    params = japi.init(key, cfg)
    prompt = japi.synth_batch(jax.random.fold_in(key, 1), cfg,
                              InputShape("serve", PROMPT, BATCH, "prefill"))
    fwd = jax.jit(lambda p, b: japi.forward(p, cfg, b, collect_cache=True))
    logits, cache, _ = fwd(params, prompt)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    step = jax.jit(lambda p, t, c, i: japi.decode_step(p, cfg, t, c, i))
    dec_logits, dec_cache = step(params, tok, cache, jnp.int32(PROMPT))
    return {"cfg": cfg, "params": _np(params), "prompt": _np(prompt),
            "logits": np.asarray(logits), "cache": _np(cache),
            "token": np.asarray(tok), "dec_logits": np.asarray(dec_logits),
            "dec_cache": _np(dec_cache)}


def test_full_size_init_and_cache_match_reference_tree():
    """The port's own init and cache at full size: the reference's paths,
    shapes and dtypes, the reference's parameter count; the cache zero but
    for the sLSTM's m, which starts at ``ssm.M_INIT`` in f32."""
    cfg = j_get_config(ARCH)
    want = jax.eval_shape(lambda: japi.init(jax.random.key(0), cfg))
    got = api.init(torch.Generator().manual_seed(0), cfg, "cpu")
    want_c = jax.eval_shape(lambda: japi.cache_init(cfg, 2, 40, jnp.bfloat16))
    got_c = api.cache_init(cfg, 2, 40, torch.bfloat16, "cpu")
    for g, w in ((got, want), (got_c, want_c)):
        assert [p for p, _ in tree_paths(g)] == [p for p, _ in tree_paths(w)]
        for (path, a), (_, b) in zip(tree_paths(g), tree_paths(w)):
            assert tuple(a.shape) == b.shape, path
            assert a.dtype == getattr(torch, b.dtype.name), path
    leaves = tree_leaves(got)
    assert len(leaves) == 20 and sum(x.numel() for x in leaves) == 162_391_392
    assert type(got_c["slstm"]) is tuple and len(got_c["slstm"]) == 4
    c, n, h, m = got_c["slstm"]
    assert m.dtype == torch.float32 and bool((m == ssm.M_INIT).all())
    assert len({x.data_ptr() for x in (c, n, h)}) == 3    # decode writes each in place
    assert not any(bool(x.any()) for x in (c, n, h, got_c["mlstm"]["state"],
                                           got_c["mlstm"]["n_state"]))


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    """One mLSTM and one sLSTM block's reference params, an input x (B 2, S
    32) and the reference's forwards and one decode step of each."""
    cfg = j_get_config(ARCH, smoke=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, PROMPT, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    out = {"cfg": cfg, "x": x, "x1": x1}
    for name, init, fwd, dec in (
            ("mlstm", jssm.mlstm_init, jssm.mlstm_forward, jssm.mlstm_decode),
            ("slstm", jssm.slstm_init, jssm.slstm_forward, jssm.slstm_decode)):
        params = init(jax.random.key(5), cfg, jnp.float32)
        y, cache = jax.jit(fwd, static_argnums=1)(params, cfg, jnp.asarray(x))
        y1, cache1 = jax.jit(dec, static_argnums=1)(params, cfg, jnp.asarray(x1), cache)
        out[name] = (_np(params), np.asarray(y), _np(cache), np.asarray(y1), _np(cache1))
    return out


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mlstm_forward_and_decode_match_reference(blocks, impl):
    cfg = blocks["cfg"]
    params, y_j, cache_j, y1_j, cache1_j = blocks["mlstm"]
    tp = bridge.from_numpy_tree(params)
    y, cache = ssm.mlstm_forward(tp, cfg, torch.from_numpy(blocks["x"]), impl=impl)
    np.testing.assert_allclose(y.numpy(), y_j, rtol=OUT_TOL, atol=OUT_TOL)
    _close_tree(cache, cache_j, CACHE_TOL)
    y1, cache1 = ssm.mlstm_decode(tp, cfg, torch.from_numpy(blocks["x1"]),
                                  bridge.from_numpy_tree(cache_j))
    np.testing.assert_allclose(y1.numpy(), y1_j, rtol=OUT_TOL, atol=OUT_TOL)
    _close_tree(cache1, cache1_j, CACHE_TOL)


def test_slstm_forward_and_decode_match_reference(blocks):
    cfg = blocks["cfg"]
    params, y_j, cache_j, y1_j, cache1_j = blocks["slstm"]
    tp = bridge.from_numpy_tree(params)
    y, cache = ssm.slstm_forward(tp, cfg, torch.from_numpy(blocks["x"]))
    assert type(cache) is tuple and cache[3].dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_j, rtol=OUT_TOL, atol=OUT_TOL)
    _close_tree(cache, cache_j, CACHE_TOL)
    y1, cache1 = ssm.slstm_decode(tp, cfg, torch.from_numpy(blocks["x1"]),
                                  bridge.from_numpy_tree(cache_j))
    np.testing.assert_allclose(y1.numpy(), y1_j, rtol=OUT_TOL, atol=OUT_TOL)
    _close_tree(cache1, cache1_j, CACHE_TOL)


# ---------------------------------------------------------------------------
# The model through the api, and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_forward_matches_reference(reference, impl):
    cfg = reference["cfg"]
    logits, cache, aux = api.forward(bridge.from_numpy_tree(reference["params"]), cfg,
                                     bridge.from_numpy_tree(reference["prompt"]),
                                     impl=impl, collect_cache=True)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), reference["logits"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _close_tree(cache, reference["cache"], CACHE_TOL)
    assert type(cache["slstm"]) is tuple
    assert cache["mlstm"]["state"].shape[:2] == (cfg.num_layers // 2, BATCH)


def test_decode_step_matches_reference(reference):
    cfg = reference["cfg"]
    cache = bridge.from_numpy_tree(reference["cache"])
    logits, new = api.decode_step(bridge.from_numpy_tree(reference["params"]), cfg,
                                  torch.tensor(reference["token"]), cache, PROMPT)
    assert new is cache     # written in place
    np.testing.assert_allclose(logits.numpy(), reference["dec_logits"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _close_tree(new, reference["dec_cache"], CACHE_TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_then_decode_matches_forward(reference, impl):
    """Prefill S 12 (one ragged scan chunk of the smoke chunk 16), then
    three decode steps, each against the forward over the longer prompt."""
    cfg, s = reference["cfg"], 12
    params = bridge.from_numpy_tree(reference["params"])
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, s), dtype=np.int32))
    logits, cache, _ = api.forward(params, cfg, {"tokens": tokens}, impl=impl,
                                   collect_cache=True)
    cache = serve._grow_attention_caches(cache, s, s + 3)
    for i in range(3):
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        tokens = torch.cat([tokens, nxt], dim=1)
        want, _, _ = api.forward(params, cfg, {"tokens": tokens}, impl=impl)
        logits, cache = api.decode_step(params, cfg, nxt, cache, s + i)
        np.testing.assert_allclose(logits[:, 0].numpy(), want[:, -1].numpy(),
                                   rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


def test_bf16_forward_keeps_the_cache_dtypes(reference):
    """In bf16 the mLSTM states come back in bf16 (the kernel's f32 states
    cast, as the reference's chunked form leaves them) and the sLSTM's
    (c, n, h, m) as bf16, bf16, bf16, f32; the bridge keeps each leaf's
    dtype both ways."""
    cfg = reference["cfg"].with_(param_dtype="bfloat16", activation_dtype="bfloat16")
    params = _np(japi.init(jax.random.key(1), cfg))
    prompt = reference["prompt"]
    logits_j, cache_j, _ = jax.jit(lambda p, b: japi.forward(p, cfg, b, collect_cache=True))(
        params, prompt)
    logits, cache, _ = api.forward(bridge.from_numpy_tree(params), cfg,
                                   bridge.from_numpy_tree(prompt), collect_cache=True)
    assert [x.dtype for x in cache["slstm"]] == [torch.bfloat16] * 3 + [torch.float32]
    assert cache["mlstm"]["state"].dtype == cache["mlstm"]["n_state"].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=BF16_TOL,
                               atol=BF16_TOL)
    _close_tree(cache, cache_j, BF16_TOL)
    back = bridge.from_numpy_tree(bridge.to_numpy_tree(cache))
    for (path, a), (_, b) in zip(tree_paths(back), tree_paths(cache)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


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


def test_serve_draws_its_own_weights_and_runs_from_the_cli(capsys):
    cfg = get_config(ARCH, smoke=True)
    a = serve.serve_session(cfg, 2, 16, 3, seed=1, device="cpu", verbose=False)
    b = serve.serve_session(cfg, 2, 16, 3, seed=1, device="cpu", verbose=False)
    assert torch.equal(a.tokens, b.tokens)
    assert all(bool(torch.isfinite(x).all()) for x in a.logits)
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "32", "--gen", "3"]) == 0
    assert "[serve] prefill 2x32" in capsys.readouterr().out


def test_prompt_not_a_multiple_of_the_chunk_raises(reference):
    params = bridge.from_numpy_tree(reference["params"])
    with pytest.raises(ValueError, match="not divisible"):
        serve.serve_session(reference["cfg"], 1, 20, 2, device="cpu", params=params,
                            verbose=False)


# ---------------------------------------------------------------------------
# Trees with tuple nodes
# ---------------------------------------------------------------------------

def test_trees_walk_tuples_and_keep_lists_and_named_tuples_as_leaves():
    a, b = torch.zeros(2), torch.ones(3)
    tree = {"s": (a, b), "l": [a, b], "o": AdamState(torch.tensor(1), {}, {})}
    paths = [p for p, _ in tree_paths(tree)]
    assert paths == [("l",), ("o",), ("s", "0"), ("s", "1")]
    assert paths == [p for p, _ in tree_paths(jax.tree.map(
        lambda x: x, {"s": (0, 1), "l": 2, "o": 3}))]
    mapped = tree_map(lambda x: x, tree)
    assert type(mapped["s"]) is tuple and mapped["s"][1] is b
    assert mapped["l"] is tree["l"] and mapped["o"] is tree["o"]
    # a map whose fn returns tuples keeps them as leaves under a walk led
    # by a tree of the first structure
    pairs = tree_map(lambda x: (x, x + 1), {"w": a})
    assert torch.equal(tree_map(lambda _, pr: pr[1], {"w": a}, pairs)["w"], a + 1)
    assert tree_from_paths(tree_paths({"s": (a, b)})) == {"s": {"0": a, "1": b}}


@pytest.mark.parametrize("task", ["resnet8", "nlp"])
def test_pack_layouts_unchanged_by_tuple_walk(task):
    """The masked-Adam pack layout (leaf order, shapes, padding, rows) of
    ResNet-8 and of the nlp transformer at full width is the reference's."""
    if task == "resnet8":
        jtree = _np(j_resnet_task("resnet8").init(jax.random.key(1)))
        tree, rows = bridge.from_numpy_tree(jtree), 1_576
    else:
        jtree = jax.eval_shape(j_nlp_task(num_classes=4).init, jax.random.key(0))
        tree, rows = nlp_task(num_classes=4).init(torch.Generator().manual_seed(0)), 85_312
    _, meta = pack_ops.pack(tree, 8)
    assert meta.rows == pack_ops.packed_rows(tree, 8) == j_pack.packed_rows(jtree, 8) == rows
    jleaves = [(p, tuple(x.shape)) for p, x in tree_paths(jtree)]
    assert list(zip(meta.paths, meta.shapes)) == jleaves
    assert all(pn % (8 * 128) == 0 and pn >= n for n, pn in zip(meta.sizes, meta.padded))
