"""The port's architecture registry against the reference's: the port
registers every name the reference does and no other, each config equal
field by field (full and smoke)."""

import dataclasses

import pytest

from repro.configs import available_archs as j_available_archs
from repro.configs import get_config as j_get_config
from repro_torch.configs import available_archs, get_config


def test_registry_names():
    assert available_archs() == j_available_archs()
    assert {"resnet8", "resnet18", "whisper-small", "llava-next-34b"} <= set(available_archs())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", sorted(set(available_archs()) & set(j_available_archs())))
def test_configs_equal_the_reference(name, smoke):
    assert dataclasses.asdict(get_config(name, smoke=smoke)) == \
        dataclasses.asdict(j_get_config(name, smoke=smoke))
