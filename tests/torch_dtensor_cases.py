"""Cases shared by the DTensor-step files (``test_torch_dtensor_step.py``,
``test_torch_dtensor_moe.py``, ``test_torch_dtensor_hybrid.py``): the
port's sharded train, prefill and decode steps (``launch.steps``
``make_sharded_*``) in gloo rank subprocesses at meshes (1, 2) and (2, 2),
against the reference's ``jax.jit`` of the same steps on the same inputs.

``start_runs`` writes each architecture's inputs (the reference's smoke
params from ``api.init(jax.random.key(0))``, a numpy batch, a random
decode cache) under a temporary directory, starts one process per rank
of each mesh (``file://`` rendezvous, 60 s collective timeout, no
``jax`` imported), and returns handles; ``reference`` computes the
reference's outputs in this process meanwhile; ``collect`` waits for the
ranks and reads rank 0's outputs (``full_tensor()`` of each DTensor) and
every rank's meta.  Each rank runs, per architecture and per ``MODES``
entry:

* ``fnu``  — one FNU train step (Adam at ``lr`` 1e-3, ``eps`` 1e-3, remat):
  the loss, the updated params and Adam's ``m``;
* ``part`` — one FedPart step on the first layer of the first stack;
* ``accum`` — the FNU step with two microbatches (``accum=2``);
* ``prefill`` — ``make_sharded_prefill_step`` with ``impl="kernel"`` (on the
  CPU, each rank's heads through the kernels' plain versions): the last
  position's logits and the cache;
* ``decode`` — one decode token against the random cache at ``POS``: the
  logits and the updated cache;
* ``ep`` (MoE configs) — ``fnu`` under expert parallelism;
* ``fsdp`` — ``fnu`` on the FSDP placements (d_model over "data" too).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim.adam import AdamConfig as JAdamConfig
from repro_torch.tree import tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
B, S = 4, 16           # S a multiple of the smoke scan chunk (16)
T, POS = 16, 5         # decode cache length and the token's position
LR, EPS = 1e-3, 1e-3
TOL = 1e-5
PART_GROUP = 1         # list_groups()[1]: the first layer of the first stack

_RANK_SCRIPT = r"""
import json, os, sys, time
from datetime import timedelta
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, data, model, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                  int(sys.argv[4]), sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        rank=rank, world_size=world, timeout=timedelta(seconds=60))

from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.optim.adam import AdamConfig
from repro_torch.tree import tree_from_paths, tree_map, tree_map_with_path, tree_paths

CASES = %(cases)r
B, T, POS, LR, EPS, GROUP = %(consts)r
mesh = make_host_mesh(data, model, "cpu")
arrays, meta = {}, {"jax_loaded": False, "redistributed": {}, "seconds": {}}


def full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().numpy()


def save(prefix, tree):
    for p, x in tree_paths(tree):
        arrays[prefix + "/".join(p)] = full(x)


for arch, overrides, modes in CASES:
    cfg = get_config(arch, smoke=True).with_(**overrides)
    z = np.load(os.path.join(out, "..", arch + ".npz"))
    params = tree_from_paths((tuple(k[2:].split("/")), torch.as_tensor(z[k]))
                             for k in z.files if k.startswith("p/"))
    batch = {k[2:]: torch.as_tensor(z[k]) for k in z.files if k.startswith("b/")}
    placed = sharding.shard_params(params, mesh)
    adam = AdamConfig(lr=LR, eps=EPS)
    for mode in modes:
        t0 = time.time()
        tag = f"{arch}/{mode}/"
        if mode in ("fnu", "part", "accum", "ep", "fsdp"):
            group = steps.list_groups(params)[GROUP] if mode == "part" else None
            placed = sharding.shard_params(params, mesh, fsdp=mode == "fsdp")
            trained = placed if group is None else steps._select_group(placed, group)
            opt = steps.shard_opt_state(steps.init_opt_state(
                params if group is None else steps._select_group(params, group)), trained)
            step = steps.make_sharded_train_step(cfg, mesh, adam, group=group,
                                                 accum=2 if mode == "accum" else 1,
                                                 use_moe_ep=mode == "ep",
                                                 fsdp=mode == "fsdp")
            new, new_opt, loss = step(placed, opt, steps.shard_inputs(batch, mesh))
            arrays[tag + "loss"] = full(loss)
            save(tag + "p/", new)
            save(tag + "m/", new_opt.m)
            meta["redistributed"][tag] = step.redistributed
            meta[tag + "same_layout"] = all(
                tuple(a.placements) == tuple(b.placements)
                for (_, a), (_, b) in zip(tree_paths(new), tree_paths(placed)))
        elif mode == "prefill":
            pb = {k: v for k, v in batch.items() if k != "labels"}
            step = steps.make_sharded_prefill_step(cfg, mesh, impl="kernel")
            with torch.no_grad():
                logits, cache = step(placed, steps.shard_inputs(pb, mesh))
            arrays[tag + "logits"] = full(logits)
            save(tag + "c/", cache)
            meta["redistributed"][tag] = step.redistributed
        elif mode == "decode":
            like = api.cache_init(cfg, B, T, torch.float32, "cpu")
            cache = tree_map_with_path(lambda p, _: torch.as_tensor(z["c/" + p]), like)
            io = steps.shard_inputs({"token": torch.as_tensor(z["token"]), "cache": cache},
                                    mesh)
            step = steps.make_sharded_serve_step(cfg, mesh)
            with torch.no_grad():
                logits, new_cache = step(placed, io["token"], io["cache"], POS)
            arrays[tag + "logits"] = full(logits)
            save(tag + "c/", new_cache)
            meta[tag + "in_place"] = all(
                a is b for (_, a), (_, b) in zip(tree_paths(new_cache),
                                                 tree_paths(io["cache"])))
        meta["seconds"][tag] = time.time() - t0

meta["jax_loaded"] = "jax" in sys.modules
if rank == 0:
    np.savez(os.path.join(out, "out.npz"), **arrays)
with open(os.path.join(out, f"meta_r{rank}.json"), "w") as f:
    json.dump(meta, f)
dist.destroy_process_group()
"""


def _jcfg(arch, overrides):
    return j_get_config(arch, smoke=True).with_(**overrides)


def inputs(arch: str, overrides: dict, seed: int) -> dict:
    """The reference's params, a numpy batch (tokens / labels (B, S), and
    whisper's frames or a VLM's media), a decode token and a random decode
    cache of length ``T``."""
    cfg = _jcfg(arch, overrides)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, japi.init(jax.random.key(seed), cfg))
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.kind == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.num_media_tokens > 0:
        batch["media"] = rng.standard_normal((B, cfg.num_media_tokens, cfg.d_model)).astype(
            np.float32)
    cache = jax.tree.map(
        lambda x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32),
        japi.cache_init(cfg, B, T, jnp.float32))
    token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    return {"params": params, "batch": batch, "cache": cache, "token": token}


def _save(path, inp):
    arrays = {"p/" + "/".join(p): v for p, v in tree_paths(inp["params"])}
    arrays.update({"b/" + k: v for k, v in inp["batch"].items()})
    arrays.update({"c/" + "/".join(p): v for p, v in tree_paths(inp["cache"])})
    np.savez(path, token=inp["token"], **arrays)


def start_runs(base, cases: list) -> tuple[dict, dict]:
    """Write the inputs of ``cases`` ((arch, config overrides, modes)) under
    ``base`` and start every rank of both meshes; returns (inputs per arch,
    processes per mesh)."""
    ins = {}
    for i, (arch, overrides, _) in enumerate(cases):
        ins[arch] = inputs(arch, overrides, i)
        _save(base / f"{arch}.npz", ins[arch])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    script = _RANK_SCRIPT % {"cases": cases, "consts": (B, T, POS, LR, EPS, PART_GROUP)}
    procs = {}
    for name, (data, model) in MESHES.items():
        out = base / name
        out.mkdir()
        procs[name] = [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(data * model), str(data), str(model),
             str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(data * model)]
    return ins, procs


def reference(arch: str, overrides: dict, inp: dict, modes) -> dict:
    """The reference's outputs of each mode (``jax.jit`` of its steps)."""
    cfg = _jcfg(arch, overrides)
    p, batch = inp["params"], inp["batch"]
    adam = JAdamConfig(lr=LR, eps=EPS)
    out = {}
    for mode in modes:
        if mode in ("fnu", "accum", "ep", "fsdp"):
            step = jax.jit(jsteps.make_train_step(cfg, adam, remat=False,
                                                  accum=2 if mode == "accum" else 1))
            new, opt, loss = step(p, jsteps.init_opt_state(p), batch)
            out[mode] = {"loss": loss, "p": new, "m": opt.m}
        elif mode == "part":
            group = jsteps.list_groups(p)[PART_GROUP]
            step = jax.jit(jsteps.make_fedpart_train_step(cfg, group, adam, remat=False))
            new, opt, loss = step(p, jsteps.init_partial_opt_state(p, group), batch)
            out[mode] = {"loss": loss, "p": new, "m": opt.m}
        elif mode == "prefill":
            pb = {k: v for k, v in batch.items() if k != "labels"}
            logits, cache = jax.jit(jsteps.make_prefill_step(cfg))(p, pb)
            out[mode] = {"logits": logits, "c": cache}
        elif mode == "decode":
            logits, cache = jax.jit(jsteps.make_serve_step(cfg))(
                p, inp["token"], inp["cache"], POS)
            out[mode] = {"logits": logits, "c": cache}
    return jax.tree.map(np.asarray, out)


def collect(base, procs: dict, timeout: float = 240) -> dict:
    """Wait for every rank; returns per mesh (rank 0's arrays, every rank's
    meta)."""
    allp = [p for ps in procs.values() for p in ps]
    try:
        logs = {p: p.communicate(timeout=timeout) for p in allp}
    finally:
        for p in allp:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p in allp:
        assert p.returncode == 0, logs[p][1][-4000:]
    got = {}
    for name, (data, model) in MESHES.items():
        with np.load(base / name / "out.npz") as z:
            arrays = {k: z[k] for k in z.files}
        metas = []
        for r in range(data * model):
            with open(base / name / f"meta_r{r}.json") as f:
                metas.append(json.load(f))
        got[name] = (arrays, metas)
    return got


def close(a, b, what: str, tol: float = TOL) -> None:
    """Within ``tol`` absolute plus ``tol`` relative, as
    ``test_torch_xlstm.py`` holds its caches: the SSD wrapper's plain
    version (a sequential recurrence) and the reference's chunked form
    differ by ~2e-6 relative on xLSTM states of magnitude ~5."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def check_train(got, ref, arch: str, mode: str) -> None:
    """Loss, every updated param and Adam's ``m`` against the reference."""
    arrays, metas = got
    r = ref[arch][mode]
    close(arrays[f"{arch}/{mode}/loss"], r["loss"], "loss")
    for key in ("p", "m"):
        for p, v in tree_paths(r[key]):
            close(arrays[f"{arch}/{mode}/{key}/" + "/".join(p)], v, f"{key}/{'/'.join(p)}")
    assert all(m[f"{arch}/{mode}/same_layout"] for m in metas)


def check_serve(got, ref, arch: str, mode: str) -> None:
    """Logits and the cache against the reference."""
    arrays, metas = got
    r = ref[arch][mode]
    close(arrays[f"{arch}/{mode}/logits"], r["logits"], "logits")
    for p, v in tree_paths(r["c"]):
        close(arrays[f"{arch}/{mode}/c/" + "/".join(p)], v, "cache/" + "/".join(p))
    if mode == "decode":
        assert all(m[f"{arch}/decode/in_place"] for m in metas)
