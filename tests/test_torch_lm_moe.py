"""The causal-LM task and its dropless MoE layer at a small size on the CPU:
``lm_task``'s loss and gradients against the plain reference of the
DeepSeek-V2-Lite cell (``perfbench/configs/deepseek-v2-lite/reference.py``)
on seeded random weights; the grouped SwiGLU under ``vmap(grad)`` against
a per-client loop, with every token routed to one expert and none
dropped; the backwards' profiler labels; the experts' shares adding up to
the uncut layer; YaRN's frequencies and scale.  The ``gpu`` test runs the grouped kernels against
their plain version and one vmapped MoE step with the host forbidden to
wait on the card.  Nothing here imports JAX."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import fedref
from perfbench.manifest import load_module
from repro_torch.configs import get_config
from repro_torch.kernels.grouped_mm import grouped_mm_ref, grouped_mm_wgrad_ref, grouped_swiglu
from repro_torch.models import moe
from repro_torch.models.layers import mlp_apply, rope_angles, yarn_mscale, yarn_ramp
from repro_torch.tree import path_str, tree_paths

ROOT = Path(__file__).resolve().parent.parent
CDIR = ROOT / "perfbench" / "configs" / "deepseek-v2-lite"
SMALL = dict(hidden_size=32, num_attention_heads=2, num_key_value_heads=2, kv_lora_rank=16,
             qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, intermediate_size=48,
             moe_intermediate_size=16, n_routed_experts=4, router_experts=8,
             num_experts_per_tok=3, num_layers=3, vocab_size=97, seq_len=12)


def _cell(**override):
    cfg = json.loads((CDIR / "config.json").read_text())
    cfg.update(SMALL, **override)
    ref = load_module(CDIR / "reference.py", "lm_moe_reference")
    prog = load_module(CDIR / "program.py", "lm_moe_program")
    return cfg, ref, prog


def _moe_cfg(**kw):
    base = get_config("deepseek-v2-lite", smoke=True).with_(
        d_model=16, num_experts=16, num_experts_per_tok=4, moe_d_ff=8, num_shared_experts=2)
    return base.with_(**kw)


def _moe_params(cfg, seed=0):
    return moe.moe_init(torch.Generator().manual_seed(seed), cfg, torch.float32, "cpu")


@pytest.mark.parametrize("first_expert", [0, 4])
def test_lm_task_loss_and_gradients_match_the_reference(first_expert):
    cfg, ref, prog = _cell(first_expert=first_expert)
    leaves = ref.leaves(cfg)
    p0 = fedref.init_params(leaves, 11, "cpu")
    x, y = ref.make_data(cfg, 3, 12)
    x, y = torch.as_tensor(x), torch.as_tensor(y.astype(np.int64))
    adapter = prog.make_task(cfg)
    port = adapter.init(torch.Generator().manual_seed(0))
    assert {path_str(p): tuple(t.shape) for p, t in tree_paths(port)} == \
        {lf.path: lf.shape for lf in leaves}

    def grads(loss_fn):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        loss = loss_fn(p)
        return loss.detach(), torch.autograd.grad(loss, list(p.values()))

    ref_loss, ref_g = grads(lambda p: ref.loss(p, cfg, x, y))
    port_loss, port_g = grads(lambda p: adapter.loss_and_stats(fedref.nest(p), x, y)[0])
    torch.testing.assert_close(port_loss, ref_loss, rtol=1e-6, atol=1e-6)
    # f32 sums in another order (MLA's recomputed backward, the grouped
    # products): each leaf's gradient within 1e-5 of the reference's norm
    # (about 1e-6 seen), far below TF32's 1e-3
    for k, a, b in zip(p0, port_g, ref_g):
        assert float((a - b).norm() / b.norm()) < 1e-5, k
    acc = adapter.evaluate(fedref.nest(p0), x, y)
    logits, _ = ref.logits(p0, cfg, x)
    assert float(acc) == float((logits.argmax(-1) == y).float().mean())


def _swiglu_loop(xf, order, ends, wg, wu, wd, k):
    """One client's held experts, group by group, in plain autograd."""
    x_in = xf[order // k]
    e = [0] + ends.tolist()
    outs = [(torch.nn.functional.silu(x_in[e[i]:e[i + 1]] @ wg[i])
             * (x_in[e[i]:e[i + 1]] @ wu[i])) @ wd[i] for i in range(len(e) - 1)]
    return torch.cat(outs + [torch.zeros(x_in.shape[0] - e[-1], xf.shape[1])])


@pytest.mark.parametrize("argnums", [(0, 1, 2, 3), (0,), (1, 2, 3)],
                         ids=["all", "tokens", "weights"])
def test_grouped_swiglu_under_vmap_grad_equals_a_per_client_loop(argnums):
    """Three clients with their own routing (one group taking every entry,
    empty groups, entries of experts not held past the groups), under
    ``vmap(grad)`` with respect to the tokens, the weights or both (the
    frozen inputs' gradients are not computed), against a loop."""
    gen = torch.Generator().manual_seed(1)
    c, t, top, g, d, f = 3, 5, 3, 4, 6, 7
    xf = torch.randn(c, t, d, generator=gen)
    wg, wu = torch.randn(c, g, d, f, generator=gen), torch.randn(c, g, d, f, generator=gen)
    wd = torch.randn(c, g, f, d, generator=gen)
    counts = torch.tensor([[15, 0, 0, 0], [2, 3, 0, 4], [0, 0, 0, 1]])
    ends = counts.cumsum(1).int()
    order = torch.stack([torch.randperm(t * top, generator=gen) for _ in range(c)])

    def f(xc, gc, uc, dc, oc, ec):
        return (grouped_swiglu(xc, oc, ec, gc, uc, dc, top).sin()).sum()

    grads, val = torch.func.vmap(torch.func.grad_and_value(f, argnums=argnums))(
        xf, wg, wu, wd, order, ends)
    for i in range(c):
        ins = [a[i].clone().requires_grad_(j in argnums) for j, a in enumerate((xf, wg, wu, wd))]
        loss = _swiglu_loop(*ins[:1], order[i], ends[i], *ins[1:], top).sin().sum()
        want = torch.autograd.grad(loss, [ins[j] for j in argnums])
        torch.testing.assert_close(val[i], loss.detach())
        for a, b in zip(grads, want):
            torch.testing.assert_close(a[i], b)


def test_mla_and_expert_backwards_run_under_their_labels():
    """The MLA scores' and the grouped experts' backwards open the ``mla``
    and ``moe_experts`` ranges, as their forwards do."""
    from repro_torch.kernels.grouped_mm import ops
    from repro_torch.models.attention import MLA

    assert ops.MOE_EXPERTS == moe.MOE_EXPERTS
    cfg, ref, prog = _cell()
    adapter = prog.make_task(cfg)
    params = torch.utils._pytree.tree_map(lambda a: a.requires_grad_(True),
                                          adapter.init(torch.Generator().manual_seed(0)))
    x, y = ref.make_data(cfg, 2, 12)
    x, y = torch.as_tensor(x), torch.as_tensor(y.astype(np.int64))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss = adapter.loss_and_stats(params, x, y)[0]
        loss.backward()
    names = [e.name for e in prof.events()]
    moe_layers = cfg["num_layers"] - cfg["first_k_dense_replace"]
    assert names.count(MLA) == 2 * cfg["num_layers"]
    assert names.count(moe.MOE_EXPERTS) == 2 * moe_layers


def test_dropless_layer_drops_nothing_when_every_token_picks_one_expert():
    """The router's weights send every token's first choice to expert 1: a
    capacity-bounded layer drops most of them; the dropless layer computes
    every entry, vmapped over clients as the loop computes them one by one."""
    cfg = _moe_cfg(experts_held=4, first_expert=0)
    p = _moe_params(cfg)
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    p["router"]["w"][:, 1] = 5.0
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(3, 2, 6, cfg.d_model, generator=gen) + 0.5      # (clients, B, S, d)

    def f(params, xc):
        y, aux = moe.moe_apply_dropless(params, cfg, xc)
        return (y * y).sum() + aux

    stacked = {k: v for k, v in p.items()}
    stacked = torch.utils._pytree.tree_map(lambda a: a.expand(3, *a.shape).clone(), stacked)
    g_v, val = torch.func.vmap(torch.func.grad_and_value(f))(stacked, x)
    for c in range(3):
        pc = torch.utils._pytree.tree_map(lambda a: a.clone().requires_grad_(True), p)
        loss = f(pc, x[c])
        grads = torch.autograd.grad(loss, torch.utils._pytree.tree_leaves(pc))
        torch.testing.assert_close(val[c], loss.detach())
        for a, b in zip(torch.utils._pytree.tree_leaves(g_v), grads):
            torch.testing.assert_close(a[c], b)
    # every entry counted: expert 1's rows are every token's, none dropped
    xf = x[0].reshape(-1, cfg.d_model)
    _, gates, idx = moe.route(p, cfg, xf)
    assert bool((idx[:, 0] == 1).all())
    y, _ = moe.moe_apply_dropless(p, cfg, x[0])
    routed = y.reshape(-1, cfg.d_model) - mlp_apply(p["shared"], cfg.mlp_kind, xf)
    want = torch.zeros_like(routed)
    for j in range(cfg.num_experts_per_tok):
        for e in range(4):
            ee = moe.experts_apply({k: v[e:e + 1] for k, v in p["experts"].items()},
                                   xf[None])[0]
            want += torch.where((idx[:, j] == e)[:, None], gates[:, j:j + 1] * ee, 0.0)
    torch.testing.assert_close(routed, want, rtol=1e-5, atol=1e-6)


def test_eight_shares_of_the_experts_add_up_to_the_uncut_layer():
    """8 shares of 16 experts (2 each, as 64 over 8 cards) through the port's
    layer: their routed parts, with the shared experts counted once, are the
    uncut plain reference layer's, which holds all 16."""
    full = _moe_cfg()
    p = _moe_params(full, seed=3)
    x = torch.randn(2, 5, full.d_model, generator=torch.Generator().manual_seed(4))
    _, ref, _ = _cell()
    flat = {f"moe/{k}": v for k, v in fedref.flatten(p).items()}
    uncut = dict(num_experts_per_tok=4, router_experts=16, first_expert=0, n_routed_experts=16,
                 aux_loss_alpha=full.aux_loss_weight)
    y_ref, aux_ref = ref._moe(flat, "moe", uncut, x)
    shared = mlp_apply(p["shared"], full.mlp_kind, x)
    total = shared.clone()
    for s in range(8):
        cfg = full.with_(experts_held=2, first_expert=2 * s)
        ps = {**p, "experts": {k: v[2 * s:2 * s + 2] for k, v in p["experts"].items()}}
        y, aux = moe.moe_apply_dropless(ps, cfg, x)
        torch.testing.assert_close(aux, aux_ref)
        total = total + (y - shared)
    torch.testing.assert_close(total, y_ref, rtol=1e-5, atol=1e-6)


def test_yarn_frequencies_and_scale_are_deepseek_v2s():
    cfg = get_config("deepseek-v2-lite")
    yarn = (cfg.yarn_factor, cfg.yarn_original_max_positions, cfg.yarn_beta_fast,
            cfg.yarn_beta_slow)
    gamma = yarn_ramp(64, 1e4, *yarn[1:])
    i = torch.arange(32, dtype=torch.float32)
    want_gamma = 1.0 - ((i - 10) / 13).clamp(0, 1)
    torch.testing.assert_close(gamma, want_gamma)
    assert gamma[:11].eq(1).all() and gamma[23:].eq(0).all()
    f = 1.0 / (1e4 ** (2 * i / 64))
    want = (1 - want_gamma) / 40 * f + want_gamma * f
    cos, sin = rope_angles(torch.tensor([1]), 64, 1e4, yarn)
    torch.testing.assert_close(cos[0], torch.cos(want))
    torch.testing.assert_close(sin[0], torch.sin(want))
    m = yarn_mscale(40.0, 0.707)
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert 192 ** -0.5 * m * m == pytest.approx(192 ** -0.5 * 1.2608 ** 2, rel=2e-4)
    cfg_ref, ref, _ = _cell()
    _, _, scale = ref.rope_tables({**cfg_ref, "qk_nope_head_dim": 128,
                                   "qk_rope_head_dim": 64}, 4, "cpu")
    assert scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert math.isclose(cfg.yarn_mscale_all_dim, 0.707)


@pytest.mark.gpu
def test_cuda_grouped_kernels_and_a_vmapped_moe_step_without_host_waits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped kernels are CUDA C++, with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k, t, top, g, d, f = 4, 4096, 6, 8, 2048, 1408
    n = t * top
    x = torch.randn(k, n, d, generator=gen, device=dev)
    w = torch.randn(k, g, d, f, generator=gen, device=dev) / d ** 0.5
    counts = torch.randint(0, 700, (k, g), generator=gen, device=dev)
    counts[0, 3] = 0                                  # an empty group
    counts[1] = torch.tensor([0] * (g - 1) + [n], device=dev)     # one group takes every row
    ends = counts.cumsum(1).int()
    from repro_torch.kernels.grouped_mm import kernel

    launches = kernel.GroupedMM.launches
    got = kernel.grouped_mm(x, w, ends)
    assert kernel.GroupedMM.launches == launches + 1
    torch.testing.assert_close(got, grouped_mm_ref(x, w, ends), rtol=1e-5, atol=1e-4)
    dy = torch.randn(k, n, f, generator=gen, device=dev)
    torch.testing.assert_close(kernel.grouped_mm(dy, w.transpose(-1, -2), ends),
                               grouped_mm_ref(dy, w.transpose(-1, -2), ends),
                               rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(kernel.grouped_mm_wgrad(x, dy, ends),
                               grouped_mm_wgrad_ref(x, dy, ends), rtol=1e-5, atol=1e-2)
    # widths that are no multiple of a tile or of 4, any strides
    xs = torch.randn(3, 37, 13, generator=gen, device=dev)
    ws = torch.randn(3, 5, 21, 13, generator=gen, device=dev).transpose(-1, -2)
    es = torch.tensor([[0, 5, 5, 30, 37], [37, 37, 37, 37, 37], [1, 2, 3, 4, 20]],
                      dtype=torch.int32, device=dev)
    torch.testing.assert_close(kernel.grouped_mm(xs, ws, es), grouped_mm_ref(xs, ws, es))
    dys = torch.randn(3, 37, 21, generator=gen, device=dev)
    torch.testing.assert_close(kernel.grouped_mm_wgrad(xs, dys, es),
                               grouped_mm_wgrad_ref(xs, dys, es))

    cfg = get_config("deepseek-v2-lite").with_(experts_held=8, param_dtype="float32",
                                               activation_dtype="float32")
    p = moe.moe_init(torch.Generator(device=dev).manual_seed(1), cfg, torch.float32, dev)
    stacked = torch.utils._pytree.tree_map(lambda a: a.expand(k, *a.shape).clone(), p)
    xs = torch.randn(k, 2, t // 2, d, generator=gen, device=dev)

    def step(params, xc):
        y, aux = moe.moe_apply_dropless(params, cfg, xc)
        return (y * y).mean() + aux

    fn = torch.func.vmap(torch.func.grad_and_value(step))
    fn(stacked, xs)                                   # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads, loss = fn(stacked, xs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss).all())
    assert all(bool(torch.isfinite(v).all()) for v in torch.utils._pytree.tree_leaves(grads))
    # the same step, one client at a time in plain autograd on the card
    for c in (0, k - 1):
        pc = torch.utils._pytree.tree_map(lambda a: a[c].clone().requires_grad_(True), stacked)
        lc = step(pc, xs[c])
        want = torch.autograd.grad(lc, torch.utils._pytree.tree_leaves(pc))
        torch.testing.assert_close(loss[c], lc.detach())
        for a, b in zip(torch.utils._pytree.tree_leaves(grads), want):
            assert float((a[c] - b).norm() / b.norm().clamp_min(1e-30)) < 1e-5
