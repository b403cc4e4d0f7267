"""The port's DTensor-propagated steps for the hybrid, recurrent,
encoder-decoder and VLM architectures against the reference's ``jax.jit``
steps, at meshes (1, 2) and (2, 2) over gloo rank subprocesses
(``torch_dtensor_cases`` says how).

Zamba2 (smoke: 32 Mamba2 heads, the shared attention block), xLSTM (the
mLSTM scans and the sLSTM loop on each rank's heads), whisper (encoder,
decoder and cross attention; the 512-token vocabulary tied) and LLaVA (8
media positions ahead of the tokens).  Held, f32, within 1e-5: the FNU
step's loss, updated params and Adam ``m`` (``eps`` 1e-3), the same for a
FedPart step on the first stacked layer, the prefill's logits and caches
(``impl="kernel"``: the flash and SSD wrappers on each rank's heads), and
one decode token's logits and the updated cache.
"""

import pytest

import torch_dtensor_cases as cases

ARCHS = ["zamba2-7b", "xlstm-125m", "whisper-small", "llava-next-34b"]
MODES = ("fnu", "part", "prefill", "decode")
CASES = [(a, {}, MODES) for a in ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dtensor_hybrid")
    ins, procs = cases.start_runs(base, CASES)
    ref = {a: cases.reference(a, o, ins[a], m) for a, o, m in CASES}
    return cases.collect(base, procs), ref


def test_ranks_import_no_jax(runs):
    got, _ = runs
    for _, metas in got.values():
        assert not any(m["jax_loaded"] for m in metas)


@pytest.mark.parametrize("mode", ["fnu", "part"])
@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(runs, arch, mesh, mode):
    got, ref = runs
    cases.check_train(got[mesh], ref, arch, mode)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", list(cases.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(runs, arch, mesh, mode):
    got, ref = runs
    cases.check_serve(got[mesh], ref, arch, mode)
