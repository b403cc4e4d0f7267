"""The hand-written kernels inside a DTensor step (``models/sharded_heads.py``):
``_sdpa`` (the flash wrapper, ``impl="kernel"``, or the plain math) and
``chunked_decay_attention`` (the SSD wrapper, or the plain chunked form)
given DTensor q / k / v run on each rank's heads through ``local_map``.

Four gloo rank subprocesses on meshes (1, 4) and (2, 2) (``file://``
rendezvous, 60 s timeout) hold each wrapper's sharded output, every rank's
``full_tensor()``, within 1e-6 (f32) of the unsharded plain version on the
same seeded inputs, for:

* query and kv heads dividing "model" (H 8, Hkv 4), kv heads fewer than the
  ranks (H 4, Hkv 2 at model 4: each rank's query head reads kv head
  ``h // 2`` of the replicated K / V), MQA (H 4, Hkv 1), and query heads not
  dividing (H 6, Hkv 2 at model 4: replicated heads), causal and not, with
  a window;
* the same under ``act_sharding.activation_sharding`` (H 6 at model 4: the
  query positions over "model" where no mask counts positions; the flash
  kernel's causal and window masks keep them whole);
* the plain path, and its gradients of q, k and v (the kv gradient a
  partial sum over "model" where the ranks read different kv heads or
  query positions), with and without the activation layouts (the causal
  mask's rows cut to each rank's positions);
* the SSD scan with heads dividing (H 8) and not (H 6), y and the state;
* a DTensor handed to the flash or SSD kernel outside ``local_map`` raises
  ``TypeError``, on the CPU as on the card.

In this process: ``kv_for_heads`` picks, for any local block of query
heads, the kv heads the GQA mapping gives them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models import sharded_heads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
HEADS = [(8, 4), (4, 2), (4, 1), (6, 2)]
TOL = 1e-6

_RANK = r"""
import json, os, sys
from datetime import timedelta
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, data, model, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        rank=rank, world_size=data * model, timeout=timedelta(seconds=60))
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_kernel
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import act_sharding, attention, ssm

mesh = make_host_mesh(data, model, "cpu")
rng = np.random.default_rng(0)
B, S, D = 4, 12, 16
err, raised = {}, {}


def dt(x, heads_dim):
    return distribute_tensor(torch.from_numpy(x), mesh, [Shard(0), Shard(heads_dim)]
                             if x.shape[heads_dim] %% model == 0 else [Shard(0), Replicate()],
                             src_data_rank=None)


def worst(a, b):
    return float((a.full_tensor() - b).abs().max())


for h, hkv in %(heads)r:
    q = rng.standard_normal((B, S, h, D)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    for causal, window in ((True, 0), (False, 0), (True, 5)):
        want = attention._sdpa(*map(torch.from_numpy, (q, k, v)), None, "kernel",
                               causal=causal, window=window)
        for act in (False, True):
            with torch.no_grad(), (act_sharding.activation_sharding(mesh) if act
                                   else torch.enable_grad()):
                got = attention._sdpa(dt(q, 2), dt(k, 2), dt(v, 2), None, "kernel",
                                      causal=causal, window=window)
            err[f"flash/{h}/{hkv}/{int(causal)}/{window}/{int(act)}"] = worst(got, want)
    # the plain path and its gradients
    mask = attention.causal_mask(S, 0, "cpu")
    full = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    y = attention._sdpa(*full, mask, "plain")
    c = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    gw = torch.autograd.grad((y * c).sum(), full)
    sh = [dt(a, 2).requires_grad_(True) for a in (q, k, v)]
    ys = attention._sdpa(*sh, mask, "plain")
    err[f"plain/{h}/{hkv}"] = worst(ys, y.detach())
    gs = torch.autograd.grad((ys * distribute_tensor(c, mesh, ys.placements,
                                                     src_data_rank=None)).sum(), sh)
    err[f"grad/{h}/{hkv}"] = max(worst(a, b) for a, b in zip(gs, gw))
    with act_sharding.activation_sharding(mesh):
        sh = [dt(a, 2).requires_grad_(True) for a in (q, k, v)]
        ys = attention._sdpa(*sh, mask, "plain")
    err[f"plain_act/{h}/{hkv}"] = worst(ys, y.detach())
    gs = torch.autograd.grad((ys * distribute_tensor(c, mesh, ys.placements,
                                                     src_data_rank=None)).sum(), sh)
    err[f"grad_act/{h}/{hkv}"] = max(worst(a, b) for a, b in zip(gs, gw))

for h in (8, 6):
    n, p = 8, 8
    q, k = (rng.standard_normal((B, 32, h, n)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, 32, h, p)).astype(np.float32)
    la = -np.abs(rng.standard_normal((B, 32, h))).astype(np.float32)
    want_y, want_s = ssm.chunked_decay_attention(*map(torch.from_numpy, (q, k, v, la)), 16,
                                                 impl="kernel")
    got_y, got_s = ssm.chunked_decay_attention(dt(q, 2), dt(k, 2), dt(v, 2), dt(la, 2), 16,
                                               impl="kernel")
    err[f"ssd/{h}"] = max(worst(got_y, want_y), worst(got_s, want_s))

qd = dt(rng.standard_normal((B, S, 4, D)).astype(np.float32), 2)
for name, call in (
        ("flash", lambda: flash_attention_kernel(qd.transpose(1, 2), qd.transpose(1, 2),
                                                 qd.transpose(1, 2))),
        ("ssd", lambda: ssd_chunk_kernel(qd.transpose(1, 2), qd.transpose(1, 2),
                                         qd.transpose(1, 2), qd[..., 0].transpose(1, 2)))):
    try:
        call()
        raised[name] = ""
    except TypeError as e:
        raised[name] = str(e)

with open(os.path.join(out, f"r{rank}.json"), "w") as f:
    json.dump({"err": err, "raised": raised}, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dtensor_kernels")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    script = _RANK % {"heads": HEADS}
    procs = []
    for name, (data, model) in MESHES.items():
        (base / name).mkdir()
        procs += [(name, subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(data), str(model), str(base / name)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for r in range(data * model)]
    try:
        logs = [p.communicate(timeout=180) for _, p in procs]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (_, p), (_, e) in zip(procs, logs):
        assert p.returncode == 0, e[-3000:]
    got = {}
    for name, (data, model) in MESHES.items():
        got[name] = []
        for r in range(data * model):
            with open(base / name / f"r{r}.json") as f:
                got[name].append(json.load(f))
    return got


@pytest.mark.parametrize("act", [0, 1])
@pytest.mark.parametrize("mask", ["1/0", "0/0", "1/5"])
@pytest.mark.parametrize("heads", HEADS, ids=[f"H{h}-Hkv{k}" for h, k in HEADS])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_flash_on_each_ranks_heads(runs, mesh, heads, mask, act):
    for r in runs[mesh]:
        assert r["err"][f"flash/{heads[0]}/{heads[1]}/{mask}/{act}"] <= TOL


@pytest.mark.parametrize("heads", HEADS, ids=[f"H{h}-Hkv{k}" for h, k in HEADS])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_plain_attention_and_gradients(runs, mesh, heads):
    for r in runs[mesh]:
        for what in ("plain", "grad", "plain_act", "grad_act"):
            assert r["err"][f"{what}/{heads[0]}/{heads[1]}"] <= TOL, what


@pytest.mark.parametrize("heads", [8, 6])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ssd_scan_on_each_ranks_heads(runs, mesh, heads):
    for r in runs[mesh]:
        assert r["err"][f"ssd/{heads}"] <= TOL


@pytest.mark.parametrize("kernel", ["flash", "ssd"])
def test_dtensor_outside_local_map_raises(runs, kernel):
    for ranks in runs.values():
        for r in ranks:
            assert "DTensor" in r["raised"][kernel]


@pytest.mark.parametrize("heads,kv_heads", [(8, 4), (4, 2), (4, 1), (6, 2), (12, 4)])
def test_kv_for_heads_follows_the_gqa_mapping(heads, kv_heads):
    k = torch.arange(kv_heads, dtype=torch.float32).reshape(1, 1, kv_heads, 1)
    group = heads // kv_heads
    for h_loc in range(1, heads + 1):
        if heads % h_loc:
            continue
        for h0 in range(0, heads, h_loc):
            kl, vl = sharded_heads.kv_for_heads(k, k, h0, h_loc, heads, kv_heads)
            local_group = h_loc // kl.shape[2]
            got = [int(kl[0, 0, j // local_group, 0]) for j in range(h_loc)]
            assert got == [(h0 + j) // group for j in range(h_loc)], (h0, h_loc)
            assert vl.shape == kl.shape
