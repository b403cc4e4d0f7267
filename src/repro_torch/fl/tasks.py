"""Task adapters: bind a model family to the interface the FL engine
consumes (port of ``repro.fl.tasks``: the ResNet vision task and the nlp
transformer text classifier, the paper's two tasks; and the port's own
causal-LM task, ``lm_task``, which the reference does not have).

    adapter.init(gen)                              -> params (CPU tensors)
    adapter.loss_and_stats(params, inputs, labels) -> (task loss, BN stats or None)
    adapter.features(params, inputs)               -> (B, d) penultimate features (MOON)
    adapter.evaluate(params, inputs, labels)       -> accuracy (0-d tensor)
    adapter.partition(params)                      -> core.Partition (Appendix-A groups)

The reference has separate ``loss`` and ``stats`` functions and lets XLA
merge their two forward passes; eager PyTorch would run both, so the port
returns the loss and the BN-stat updates from one forward (the nlp model
has no BN: ``None``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.partition import Partition, build_partition
from repro_torch.models import causal_lm, nlp_small, resnet
from repro_torch.tree import PyTree


@dataclasses.dataclass(frozen=True)
class TaskAdapter:
    name: str
    init: Callable[[torch.Generator], PyTree]
    loss_and_stats: Callable[[PyTree, torch.Tensor, torch.Tensor],
                             tuple[torch.Tensor, PyTree | None]]
    features: Callable[[PyTree, torch.Tensor], torch.Tensor]
    evaluate: Callable[[PyTree, torch.Tensor, torch.Tensor], torch.Tensor]
    partition: Callable[[PyTree], Partition]


_RESNET_SPECS = {
    "resnet4": resnet.RESNET4,   # test-scale: same BN/shortcut structure
    "resnet8": resnet.RESNET8,
    "resnet18": resnet.RESNET18,
}


def resnet_task(depth: str = "resnet8", num_classes: int = 20) -> TaskAdapter:
    spec = _RESNET_SPECS[depth]

    def init(gen):
        return resnet.resnet_init(gen, spec, num_classes)

    def loss_and_stats(params, images, labels):
        logits, upd = resnet.resnet_apply(params, images, train=True)
        return resnet.cls_loss(logits, labels), upd

    def evaluate(params, images, labels):
        # Batch-statistics mode: BN running stats are client-local and never
        # aggregated (paper §4), so the global model is scored with batch
        # stats on the balanced eval set (deterministic given the set).
        with torch.no_grad():
            logits, _ = resnet.resnet_apply(params, images, train=True)
            return resnet.accuracy(logits, labels)

    def make_partition(params):
        return build_partition(params, resnet.resnet_group_key, resnet.resnet_order_key)

    return TaskAdapter(
        name=depth,
        init=init,
        loss_and_stats=loss_and_stats,
        features=resnet.resnet_features,
        evaluate=evaluate,
        partition=make_partition,
    )


def nlp_task(num_classes: int = 4, cfg: ModelConfig | None = None,
             smoke: bool = False) -> TaskAdapter:
    """The paper's text task: ``nlp-transformer`` (full, or its smoke size)
    on ``(B, S)`` integer tokens."""
    cfg = cfg or get_config("nlp-transformer", smoke=smoke)

    def init(gen):
        return nlp_small.nlp_init(gen, cfg, num_classes)

    def loss_and_stats(params, tokens, labels):
        return resnet.cls_loss(nlp_small.nlp_apply(params, cfg, tokens), labels), None

    def features(params, tokens):
        return nlp_small.nlp_pooled(params, cfg, tokens)

    def evaluate(params, tokens, labels):
        with torch.no_grad():
            return resnet.accuracy(nlp_small.nlp_apply(params, cfg, tokens), labels)

    def make_partition(params):
        return build_partition(params, nlp_small.nlp_group_key)

    return TaskAdapter(
        name="nlp-transformer",
        init=init,
        loss_and_stats=loss_and_stats,
        features=features,
        evaluate=evaluate,
        partition=make_partition,
    )


def lm_task(cfg: ModelConfig) -> TaskAdapter:
    """Federated next-token training of the decoder ``cfg``
    (``models.causal_lm``) on ``(B, S)`` token inputs and ``(B, S)``
    next-token labels: the loss is cross-entropy plus the MoE layers'
    balance losses, the eval next-token accuracy, the groups the embedding,
    each layer, then the final norm with the head.  No BN: ``None`` stats;
    no pooled features (MOON is not defined for it)."""

    def init(gen):
        return causal_lm.lm_init(gen, cfg)

    def loss_and_stats(params, tokens, labels):
        return causal_lm.lm_loss(params, cfg, tokens, labels), None

    def features(params, tokens):
        raise ValueError("lm_task has no pooled features (MOON needs them)")

    def evaluate(params, tokens, labels):
        with torch.no_grad():
            return causal_lm.lm_accuracy(params, cfg, tokens, labels)

    return TaskAdapter(
        name=cfg.name,
        init=init,
        loss_and_stats=loss_and_stats,
        features=features,
        evaluate=evaluate,
        partition=build_partition,
    )
