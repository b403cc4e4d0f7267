"""The port's DTensor-propagated steps (``launch.steps``
``make_sharded_train_step`` / ``make_sharded_prefill_step`` /
``make_sharded_serve_step``) for the dense decoders against the
reference's ``jax.jit`` steps, at meshes (1, 2) and (2, 2) over gloo rank
subprocesses (``torch_dtensor_cases`` says how).

TinyLlama and Llama-3.2 (smoke: H 4, Hkv 2, so at "model" 2 both query and
kv heads shard, Llama-3.2's embedding tied), Gemma (MQA: Hkv 1, so each
rank's query heads read the one replicated kv head) and GLM-4.  Held,
f32, within 1e-5: the FNU step's loss, every updated param and Adam's
``m`` (``eps`` 1e-3, as ROADMAP's tolerances say); the same for a FedPart
step on ``blocks`` layer 0, for the FNU step with two microbatches, and
for TinyLlama's FNU step on the FSDP placements;
the prefill's last logits and its K / V cache (the flash wrapper on each
rank's heads); one decode token's logits and the updated cache, written
in place.  Params keep their placements; no rank imports ``jax``.
"""

import pytest

import torch_dtensor_cases as cases

ARCHS = ["tinyllama-1.1b", "llama3.2-1b", "gemma-2b", "glm4-9b"]
MODES = ("fnu", "part", "accum", "prefill", "decode")
CASES = [(a, {}, MODES + (("fsdp",) if a == "tinyllama-1.1b" else ())) for a in ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dtensor_step")
    ins, procs = cases.start_runs(base, CASES)
    ref = {a: cases.reference(a, o, ins[a], m) for a, o, m in CASES}
    return cases.collect(base, procs), ref


def test_ranks_import_no_jax(runs):
    got, _ = runs
    for _, metas in got.values():
        assert not any(m["jax_loaded"] for m in metas)


@pytest.mark.parametrize("mode", ["fnu", "part", "accum"])
@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(runs, arch, mesh, mode):
    got, ref = runs
    cases.check_train(got[mesh], ref, arch, mode)


@pytest.mark.parametrize("mesh", list(cases.MESHES))
def test_fsdp_train_step_matches_reference(runs, mesh):
    got, ref = runs
    cases.check_train(got[mesh], ref, "tinyllama-1.1b", "fsdp")


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(runs, arch, mesh, mode):
    got, ref = runs
    cases.check_serve(got[mesh], ref, arch, mode)
