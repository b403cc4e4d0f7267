"""The port's DTensor-propagated steps for the two MoE decoders against
the reference's ``jax.jit`` steps, at meshes (1, 2) and (2, 2) over gloo
rank subprocesses (``torch_dtensor_cases`` says how), expert parallelism
off and on.

Llama-4-Maverick (smoke: 4 experts, H 4, Hkv 2) and DeepSeek-V3 (MLA, its
MTP head, capacity factor 1.0 so that the sort dispatch drops tokens).
Without expert parallelism the router and the dispatch run on the
replicated tokens (``moe._moe_apply_dtensor``: the global capacity, as
GSPMD partitions the reference's layer) and the expert products on the
experts' shards; with it (``ep``) the layer is ``moe_ep.moe_apply_ep`` on
each rank's tokens and shards, whose capacity and aux loss are per data
shard, so there the reference is its own EP step, run by a JAX subprocess
with 4 forced host devices on the same meshes.  Held, f32, within 1e-5:
the train steps' loss, updated params and Adam ``m`` (``eps`` 1e-3; FNU,
a FedPart step on the first block, the EP step), the prefill's logits and
cache, one decode token's logits and cache.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dtensor_cases as cases

CASES = [("llama4-maverick-400b-a17b", {}, ("fnu", "part", "prefill", "decode", "ep")),
         ("deepseek-v3-671b", {"mtp_depth": 1, "capacity_factor": 1.0},
          ("fnu", "part", "prefill", "decode", "ep"))]
ARCHS = [a for a, _, _ in CASES]

# the reference's FNU step under its expert parallelism, on both meshes
_JAX_EP_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "src")
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import steps
from repro.models import moe_ep
from repro.optim.adam import AdamConfig
from repro_torch.tree import tree_from_paths, tree_paths

base, lr, eps = %(base)r, %(lr)r, %(eps)r
out = {}
for arch, overrides, _ in %(cases)r:
    cfg = get_config(arch, smoke=True).with_(**overrides)
    z = np.load(os.path.join(base, arch + ".npz"))
    params = tree_from_paths((tuple(k[2:].split("/")), z[k]) for k in z.files
                             if k.startswith("p/"))
    batch = {k[2:]: z[k] for k in z.files if k.startswith("b/")}
    for name, (data, model) in %(meshes)r.items():
        mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                    ("data", "model"))
        step = steps.make_train_step(cfg, AdamConfig(lr=lr, eps=eps), remat=False)
        with moe_ep.expert_parallel(mesh), mesh:
            new, opt, loss = jax.jit(step)(params, steps.init_opt_state(params), batch)
        tag = f"{arch}/{name}/"
        out[tag + "loss"] = np.asarray(loss)
        out.update({tag + "p/" + "/".join(p): np.asarray(v) for p, v in tree_paths(new)})
        out.update({tag + "m/" + "/".join(p): np.asarray(v) for p, v in tree_paths(opt.m)})
np.savez(os.path.join(base, "jax_ep.npz"), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dtensor_moe")
    ins, procs = cases.start_runs(base, CASES)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    jproc = subprocess.Popen([sys.executable, "-c", _JAX_EP_SCRIPT % {
        "base": str(base), "lr": cases.LR, "eps": cases.EPS, "cases": CASES,
        "meshes": cases.MESHES}], cwd=cases.ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ref = {a: cases.reference(a, o, ins[a], [m for m in ms if m != "ep"])
               for a, o, ms in CASES}
        got = cases.collect(base, procs)
        _, err = jproc.communicate(timeout=240)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, err[-4000:]
    with np.load(base / "jax_ep.npz") as z:
        jax_ep = {k: z[k] for k in z.files}
    return got, ref, jax_ep


def test_ranks_import_no_jax(runs):
    got, _, _ = runs
    for _, metas in got.values():
        assert not any(m["jax_loaded"] for m in metas)


@pytest.mark.parametrize("mode", ["fnu", "part"])
@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(runs, arch, mesh, mode):
    got, ref, _ = runs
    cases.check_train(got[mesh], ref, arch, mode)


@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_step_matches_reference_ep(runs, arch, mesh):
    got, _, jax_ep = runs
    arrays, metas = got[mesh]
    tag = f"{arch}/{mesh}/"
    keys = [k for k in jax_ep if k.startswith(tag)]
    assert any("/experts/" in k for k in keys)
    for k in keys:
        cases.close(arrays[f"{arch}/ep/" + k[len(tag):]], jax_ep[k], k)
    assert all(m[f"{arch}/ep/same_layout"] for m in metas)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(runs, arch, mesh, mode):
    got, ref, _ = runs
    cases.check_serve(got[mesh], ref, arch, mode)
