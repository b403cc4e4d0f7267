"""The port's dry run (``launch/dryrun.py``, ``cost_probes.py``,
``hlo_analysis.py``) against the JAX package's.

* ``probe_plan`` / ``fit_and_extrapolate`` equal the reference's, value
  for value, for every assigned architecture (probe configs, rows, the
  full row) and on the same cost dicts.
* Params, active params and the FSDP decision of every assigned
  architecture at full size equal the reference dry run's counts
  (``_param_count`` / ``_active_param_count`` of its ``jax.eval_shape``
  tree, its thresholds).
* (``tests/test_torch_dryrun_probes.py`` holds the probe extrapolation
  to full-depth counts.)
* In a subprocess (the dry run makes its own ``"fake"`` process group,
  which must not meet this process's): the reference's
  ``test_dryrun_small`` case, TinyLlama smoke on a 4 x 2 mesh: FLOPs > 0,
  the DP gradient all-reduce > 0 bytes, params and ``fsdp`` the
  reference's; ``--moe-ep`` on the smoke Llama-4 with 8 experts counts one
  all-reduce per MoE layer (prefill and train); whisper x ``long_500k``
  is ``skipped``; the command line prints one record with the H100
  roofline and ``fits_h100_80gb``; no ``jax`` is imported.
* (``tests/test_torch_dryrun_sharded.py`` holds the per-device counts of
  the sharded step, its collectives and ``--act-shard``.)
* ``hlo_analysis`` carries the H100 data-sheet figures and the 80e9 B
  budget, no TPU one.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import cost_probes as jprobes
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.launch import cost_probes, dryrun, hlo_analysis
from repro_torch.models import api

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_dryrun():
    """The reference's ``launch.dryrun``, whose import sets ``XLA_FLAGS``
    for 512 devices: restored here, so that no later subprocess sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_probe_plan_matches_reference(arch):
    ours, ref = cost_probes.probe_plan(get_config(arch)), jprobes.probe_plan(j_get_config(arch))
    assert [(c.num_layers, c.first_dense_layers, c.encoder_layers) for c in ours.probe_cfgs] \
        == [(c.num_layers, c.first_dense_layers, c.encoder_layers) for c in ref.probe_cfgs]
    np.testing.assert_array_equal(ours.rows, ref.rows)
    np.testing.assert_array_equal(ours.full_row, ref.full_row)
    rng = np.random.default_rng(0)
    costs = [{"flops": float(rng.uniform(1e9, 1e12)), "hbm_bytes": float(rng.uniform(1, 1e9))}
             for _ in ours.probe_cfgs]
    assert cost_probes.fit_and_extrapolate(ours, costs) == \
        jprobes.fit_and_extrapolate(ref, costs)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_counts_and_fsdp_match_reference(arch):
    jdry = _reference_dryrun()
    shapes = jax.eval_shape(lambda: japi.init(jax.random.key(0), j_get_config(arch)))
    params = api.init(torch.Generator(), get_config(arch), "meta")
    n = dryrun._param_count(params)
    assert n == jdry._param_count(shapes)
    assert dryrun._active_param_count(get_config(arch), params) == \
        jdry._active_param_count(j_get_config(arch), shapes)
    for shape in api.INPUT_SHAPES.values():
        want = n > (jdry.FSDP_TRAIN_THRESHOLD if shape.kind == "train"
                    else jdry.FSDP_SERVE_THRESHOLD)
        assert dryrun._fsdp(n, shape) == want


def test_h100_constants():
    assert hlo_analysis.PEAK_FLOPS == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    assert hlo_analysis.NVLINK_BW == 450e9
    assert hlo_analysis.HBM_BUDGET == 80e9
    t = hlo_analysis.roofline(989e12, 3.35e12, 450e9, residency_bytes=3.35e12 / 4)
    assert (t.compute_s, t.memory_s_ops, t.collective_s, t.memory_s_min) == (1, 1, 1, 0.5)
    assert t.dominant == "compute"


_SCRIPT = r"""
import contextlib, io, json, os, sys
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

out = {}
small = dryrun.analyze_pair("tinyllama-1.1b", "train_4k", mesh_shape="4,2", save=False,
                            verbose=False, cfg=get_config("tinyllama-1.1b", smoke=True))
out["small"] = small
moe = get_config("llama4-maverick-400b-a17b", smoke=True).with_(num_experts=8)
for shape in ("prefill_32k", "train_4k"):
    out["ep_" + shape] = dryrun.analyze_pair(
        "llama4-maverick-400b-a17b", shape, mesh_shape="4,2", moe_ep=True, save=False,
        verbose=False, cfg=moe)
out["whisper_long"] = dryrun.analyze_pair("whisper-small", "long_500k", save=False,
                                          verbose=False)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--no-save"])
out["cli"] = {"rc": rc, "stdout": buf.getvalue()}
out["jax_loaded"] = "jax" in sys.modules
out["group_left"] = torch.distributed.is_initialized()
print(json.dumps(out, default=float))
"""


@pytest.fixture(scope="module")
def records():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_small_mesh_dryrun(records):
    r = records["small"]
    jdry = _reference_dryrun()
    shapes = jax.eval_shape(lambda: japi.init(jax.random.key(0),
                                              j_get_config("tinyllama-1.1b", smoke=True)))
    assert r["status"] == "ok" and r["chips"] == 8 and r["mesh"] == "4x2"
    assert r["cost"]["flops"] > 0
    assert r["collectives"]["dp_all_reduce_bytes"] > 0     # data-parallel grads all-reduce
    assert r["params"] == jdry._param_count(shapes)
    assert r["fsdp"] is (r["params"] > jdry.FSDP_TRAIN_THRESHOLD) is False
    assert r["rank_batch"] == api.INPUT_SHAPES["train_4k"].global_batch // 4
    assert r["memory"]["act_peak_bytes"] > 0 and r["memory"]["opt_bytes"] > 0
    assert set(r["roofline"]) >= {"compute_s", "memory_s_min", "collective_s", "dominant"}
    assert "fits_h100_80gb" in r and "fits_v5e_16gb" not in r
    assert not records["jax_loaded"] and not records["group_left"]


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_moe_ep_counts_one_all_reduce_per_layer(records, shape):
    r = records["ep_" + shape]
    cfg = get_config("llama4-maverick-400b-a17b", smoke=True)
    assert r["moe_ep"] and r["status"] == "ok"
    n_moe = cfg.num_layers - cfg.first_dense_layers
    assert abs(r["collectives"]["ep_all_reduce_calls"] - n_moe) < 1e-9
    assert r["collectives"]["ep_all_reduce_bytes"] > 0


def test_whisper_long_decode_is_skipped(records):
    assert records["whisper_long"]["status"] == "skipped"


def test_command_line_prints_one_record(records):
    cli = records["cli"]
    assert cli["rc"] == 0
    lines = [ln for ln in cli["stdout"].splitlines() if ln.startswith("[dryrun] llama3.2-1b")]
    assert len(lines) == 1 and "fits H100 80GB" in lines[0]
    assert "done: 1/1 OK" in cli["stdout"]
