"""The system under test for this configuration: the port's nlp task
(``repro_torch.fl.tasks.nlp_task``) at the sizes of ``config.json``."""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.fl.tasks import nlp_task

FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
          "max_position_embeddings", "mlp_kind", "norm_kind", "use_rope")


def make_task(cfg: dict):
    model = get_config("nlp-transformer").with_(**{k: cfg[k] for k in FIELDS})
    return nlp_task(cfg["num_classes"], cfg=model)
