"""Serving steps (port of the serving half of ``repro.launch.steps``).

``make_prefill_step`` and ``make_serve_step`` return plain functions; the
reference's ``jax.jit`` around them has no counterpart here (PyTorch runs
eagerly).  The training steps stay with the FL port (``optim``, ``fl``).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig, *, window: int = 0, impl: str = "kernel"):
    def prefill_step(params, batch):
        logits, cache, _ = api.forward(params, cfg, batch, window=window, impl=impl,
                                       collect_cache=True)
        return logits[:, -1:, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, window: int = 0):
    def serve_step(params, token, cache, pos):
        return api.decode_step(params, cfg, token, cache, pos, window=window)

    return serve_step
