"""Paper vision models: ResNet-8 and ResNet-18 (port of
``repro.configs.resnet``).

Not transformer configs: they are registered so that ``--arch`` and
``available_archs()`` list them as the reference's do; the FL task builds
its model from ``repro_torch.models.resnet`` (``RESNET8`` / ``RESNET18``)
directly.
"""

from repro_torch.configs.base import ModelConfig, register


def _cfg(name: str) -> ModelConfig:
    # the reference's placeholder record; family="dense" keeps the
    # registry's invariants
    return ModelConfig(name=name, family="dense", kind="decoder", source="paper App. A")


register("resnet8", lambda: _cfg("resnet8"), lambda: _cfg("resnet8"))
register("resnet18", lambda: _cfg("resnet18"), lambda: _cfg("resnet18"))
