"""Cases shared by ``test_torch_steps.py`` (``tinyllama-1.1b``),
``test_torch_steps_hybrid.py`` (``zamba2-7b``), ``test_torch_steps_xlstm.py``
(``xlstm-125m``), ``test_torch_steps_moe.py`` (``llama4-maverick-400b-a17b``),
``test_torch_steps_mtp.py`` (``deepseek-v3-671b`` with its MTP head),
``test_torch_steps_encdec.py`` (``whisper-small``: batches carry frames)
and ``test_torch_steps_vlm.py`` (``llava-next-34b``: batches carry media):
each file imports them and provides the fixtures ``setup``
(``make_setup(arch)``), ``expected_groups`` and ``group_kind``; the MoE,
encoder-decoder and VLM files also call ``check_mesh_trainer_rounds``.
What they hold and at which tolerance is in those files' docstrings."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.schedule import RoundSpec as JRoundSpec
from repro.launch import fedtrain as jfedtrain
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim.adam import AdamConfig as JAdamConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.schedule import FULL_NETWORK, RoundSpec
from repro_torch.launch import fedtrain, steps
from repro_torch.models import api
from repro_torch.optim.adam import AdamConfig
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

TOL = 1e-5
EPS = 1e-3
LR = 1e-3    # AdamConfig and FLRunConfig default


def numpy_batch(cfg, rng: np.random.Generator, b: int, s: int) -> dict:
    """Tokens and labels (b, s), and the stub frontend's inputs the config
    takes: whisper's frames (b, encoder_seq, d), a VLM's media (b, n_media,
    d), ahead of the s tokens."""
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.kind == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_media_tokens > 0:
        batch["media"] = rng.standard_normal(
            (b, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return batch


def make_setup(arch: str, **overrides):
    """``(arch, ref cfg, port cfg, ref params as numpy, numpy batch)``;
    ``overrides`` go to both configs' ``with_``."""
    jcfg = j_get_config(arch, smoke=True).with_(**overrides)
    cfg = get_config(arch, smoke=True).with_(**overrides)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0), jcfg))
    batch = numpy_batch(jcfg, np.random.default_rng(7), 4, 32)
    return arch, jcfg, cfg, jparams, batch


def _flat(tree):
    return [(p, np.asarray(x)) for p, x in tree_paths(tree)]


def _close(jtree, ttree, tol=TOL):
    ja, ta = _flat(jax.tree.map(np.asarray, jtree)), _flat(bridge.to_numpy_tree(ttree))
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg="/".join(path))


def test_loss_and_grads_match_reference(setup):
    _, jcfg, cfg, jparams, batch = setup
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, batch, remat=False)))(jparams)
    params = bridge.from_numpy_tree(jparams)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = api.loss(params, cfg, bridge.from_numpy_tree(batch))
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= TOL
    for (path, a), g in zip(tree_paths(jax.tree.map(np.asarray, jg)), grads):
        np.testing.assert_allclose(g.numpy(), a, rtol=0, atol=TOL, err_msg="/".join(path))


def test_remat_is_bit_identical(setup):
    _, _, cfg, jparams, batch = setup
    out = {}
    for remat in (False, True):
        params = bridge.from_numpy_tree(jparams)
        leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
        loss = api.loss(params, cfg, bridge.from_numpy_tree(batch), remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))


def test_kernel_impl_refuses_grad(setup):
    _, _, cfg, jparams, batch = setup
    params = bridge.from_numpy_tree(jparams)
    for x in tree_leaves(params):
        x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        api.loss(params, cfg, bridge.from_numpy_tree(batch), impl="kernel")


def test_list_groups_match_reference(setup, expected_groups):
    _, _, _, jparams, _ = setup
    ref = [(g.key, g.index) for g in jsteps.list_groups(jparams)]
    port = [(g.key, g.index) for g in steps.list_groups(bridge.from_numpy_tree(jparams))]
    assert port == ref == expected_groups


@pytest.mark.parametrize("accum", [1, 2])
def test_fnu_step_matches_reference(setup, accum):
    _, jcfg, cfg, jparams, batch = setup
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamConfig(lr=LR, eps=EPS),
                                           remat=False, accum=accum))
    step = steps.make_train_step(cfg, AdamConfig(lr=LR, eps=EPS), remat=True,
                                 accum=accum)
    jp, jo = jparams, jsteps.init_opt_state(jparams)
    params = bridge.from_numpy_tree(jparams)
    opt = steps.init_opt_state(params)
    tb = bridge.from_numpy_tree(batch)
    for _ in range(2):
        jp, jo, jl = jstep(jp, jo, batch)
        params, opt, loss = step(params, opt, tb)
        assert abs(float(loss) - float(jl)) <= TOL
    _close(jp, params)
    _close(jo.m, opt.m)
    assert int(opt.step) == int(jo.step) == 2


def test_partial_step_matches_reference(setup, group_kind):
    _, jcfg, cfg, jparams, batch = setup
    key, index = group_kind
    group = steps.StackedGroup(key, index)
    jgroup = jsteps.StackedGroup(key, index)
    jstep = jax.jit(jsteps.make_fedpart_train_step(
        jcfg, jgroup, JAdamConfig(lr=LR, eps=EPS), remat=False))
    step = steps.make_fedpart_train_step(cfg, group, AdamConfig(lr=LR, eps=EPS))
    jp, jo = jparams, jsteps.init_partial_opt_state(jparams, jgroup)
    start = bridge.from_numpy_tree(jparams)
    kept = bridge.from_numpy_tree(jparams)
    params, opt = start, steps.init_partial_opt_state(start, group)
    assert sum(x.numel() for x in tree_leaves(opt.m)) == \
        sum(x.size for x in jax.tree.leaves(jo.m))
    tb = bridge.from_numpy_tree(batch)
    for _ in range(2):
        jp, jo, jl = jstep(jp, jo, batch)
        params, opt, loss = step(params, opt, tb)
        assert abs(float(loss) - float(jl)) <= TOL
    _close(jp, params)
    _close(jo.m, opt.m)

    # the inputs were never written; outside the group nothing changed
    for (path, a), (_, b) in zip(tree_paths(start), tree_paths(kept)):
        assert torch.equal(a, b), path
    names = key.split("|")
    for (path, new), (_, old) in zip(tree_paths(params), tree_paths(kept)):
        if path[0] not in names:
            assert torch.equal(new, old), path
        elif index is None:
            assert not torch.equal(new, old), path
        else:
            for layer in range(old.shape[0]):
                same = torch.equal(new[layer], old[layer])
                assert same == (layer != index), (path, layer)


def check_mesh_trainer_rounds(setup, group: int):
    """``FedPartMeshTrainer``: an FNU round, then a partial round of group
    ``group`` (two steps each, the same numpy batches) against the
    reference's trainer: per-round loss, the transmitted parameter counts,
    the final params."""
    _, jcfg, cfg, jparams, _ = setup
    jtrainer = jfedtrain.FedPartMeshTrainer(jcfg, JAdamConfig(lr=LR, eps=EPS))
    trainer = fedtrain.FedPartMeshTrainer(cfg, AdamConfig(lr=LR, eps=EPS))
    params, jp = bridge.from_numpy_tree(jparams), jparams
    assert len(trainer.groups(params)) == len(jtrainer.groups(jparams))
    rng = np.random.default_rng(3)
    for spec in (RoundSpec(0, "warmup", -1, FULL_NETWORK), RoundSpec(1, "partial", 0, group)):
        jspec = JRoundSpec(spec.index, spec.phase, spec.cycle, spec.group)
        assert trainer.transmitted_params(params, spec) == \
            jtrainer.transmitted_params(jp, jspec), spec
        batches = [numpy_batch(cfg, rng, 2, 16) for _ in range(2)]
        jp, jl = jtrainer.run_round(jp, jspec, batches)
        params, loss = trainer.run_round(params, spec,
                                         [bridge.from_numpy_tree(b) for b in batches])
        assert abs(loss - jl) <= TOL, spec
    _close(jp, params)
