"""``api.input_specs`` and ``api.supports_shape`` against the reference's,
for every architecture both register (full size) and each of the four
input shapes (``train_4k``, ``prefill_32k``, ``decode_32k``,
``long_500k``).

The port's specs are ``meta`` tensors, the reference's
``ShapeDtypeStruct`` records: the same names, tree paths, shapes and dtypes
(whisper's frames and LLaVA's media in the activation dtype, a VLM's
tokens ``seq_len - num_media_tokens`` long, a decode shape's cache from
``cache_init`` on the meta device, windowed at 500k where the reference
windows it); nothing is allocated.  ``supports_shape`` is False only for
whisper at ``long_500k``, as the reference's.  Exact: shapes and dtypes.
"""

import pytest

from repro.configs import available_archs as j_available_archs
from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro_torch.configs import available_archs, get_config
from repro_torch.models import api
from repro_torch.tree import tree_paths

SHAPES = sorted(api.INPUT_SHAPES)


def _flat(tree):
    return [(path, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for path, x in tree_paths(tree)]


def test_every_reference_arch_is_covered():
    assert available_archs() == j_available_archs()
    assert sorted(api.INPUT_SHAPES) == sorted(japi.INPUT_SHAPES)
    for name, shape in api.INPUT_SHAPES.items():
        ref = japi.INPUT_SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", j_available_archs())
def test_input_specs_match_reference(arch, shape):
    cfg = get_config(arch)
    want = japi.input_specs(j_get_config(arch), japi.INPUT_SHAPES[shape])
    got = api.input_specs(cfg, api.INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    assert all(x.device.type == "meta" for _, x in tree_paths(got))
    assert _flat(got) == _flat(want)
    assert api.supports_shape(cfg, api.INPUT_SHAPES[shape]) == \
        japi.supports_shape(j_get_config(arch), japi.INPUT_SHAPES[shape])


def test_only_whisper_skips_long_decode():
    skip = [a for a in available_archs()
            if not api.supports_shape(get_config(a), api.INPUT_SHAPES["long_500k"])]
    assert skip == ["whisper-small"]
