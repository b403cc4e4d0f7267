"""The port's architecture registry against the reference's: every name the
port registers is one of the reference's, equal field by field (full and
smoke), and every reference name the port lacks raises, naming its ROADMAP
item."""

import dataclasses

import pytest

from repro.configs import available_archs as j_available_archs
from repro.configs import get_config as j_get_config
from repro_torch.configs import available_archs, get_config


def test_registry_names():
    ported, ref = set(available_archs()), set(j_available_archs())
    assert {"resnet8", "resnet18"} <= ported <= ref
    for name in sorted(ref - ported):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 15"):
            get_config(name)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", sorted(set(available_archs()) & set(j_available_archs())))
def test_configs_equal_the_reference(name, smoke):
    assert dataclasses.asdict(get_config(name, smoke=smoke)) == \
        dataclasses.asdict(j_get_config(name, smoke=smoke))
