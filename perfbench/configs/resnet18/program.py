"""The system under test for this configuration: the port's vision task
(``repro_torch.fl.tasks.resnet_task``) whose network has the stages and
channels of ``config.json``."""

from __future__ import annotations

from repro_torch.fl.tasks import resnet_task
from repro_torch.models import resnet

SPECS = {"resnet4": resnet.RESNET4, "resnet8": resnet.RESNET8, "resnet18": resnet.RESNET18}


def make_task(cfg: dict):
    for depth, spec in SPECS.items():
        if (list(spec["stages"]) == list(cfg["stages"])
                and list(spec["channels"]) == list(cfg["channels"])):
            return resnet_task(depth, num_classes=cfg["num_classes"])
    raise ValueError(f"the port has no ResNet with stages {cfg['stages']} and "
                     f"channels {cfg['channels']}")
