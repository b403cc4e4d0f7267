"""Exact cost extrapolation from small probe configs (port of
``repro.launch.cost_probes``).

The reference needs it because XLA's ``cost_analysis`` counts a scanned
layer stack's body once.  The port's forward is a Python loop, so a
full-depth count is exact already; the dry run still fits the probes, as
the reference does, and ``tests/test_torch_dryrun.py`` holds the
extrapolation to a full-depth count.  Per (arch, shape, mesh), 1-3 probe
variants of the same architecture (1-2 layers per stack) are measured and
the exact linear model

    cost = base + sum over stacks of  n_s * per_layer_s

is fitted and evaluated at the full config's stack counts; it is exact
for homogeneous stacks (ours are, by construction).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """Probe configs, their stack-count rows, and the full config's row.

    rows[i] are the coefficients [1, n_s1, n_s2, ...] of probe i;
    full_row are the coefficients of the full-size config."""

    probe_cfgs: tuple[ModelConfig, ...]
    rows: np.ndarray
    full_row: np.ndarray


def probe_plan(cfg: ModelConfig) -> ProbePlan:
    if cfg.kind == "decoder":
        if cfg.is_moe and cfg.first_dense_layers > 0:
            # two stacks: dense (first_dense_layers) + moe (rest)
            p1 = cfg.with_(num_layers=2, first_dense_layers=1)
            p2 = cfg.with_(num_layers=3, first_dense_layers=2)
            p3 = cfg.with_(num_layers=3, first_dense_layers=1)
            rows = np.array([[1, 1, 1], [1, 2, 1], [1, 1, 2]], float)
            full = np.array(
                [1, cfg.first_dense_layers, cfg.num_layers - cfg.first_dense_layers],
                float,
            )
            return ProbePlan((p1, p2, p3), rows, full)
        # single homogeneous stack (dense, or all-moe)
        p1 = cfg.with_(num_layers=1, first_dense_layers=0)
        p2 = cfg.with_(num_layers=2, first_dense_layers=0)
        rows = np.array([[1, 1], [1, 2]], float)
        return ProbePlan((p1, p2), rows, np.array([1, cfg.num_layers], float))
    if cfg.kind == "xlstm":
        p1 = cfg.with_(num_layers=2)   # 1 pair
        p2 = cfg.with_(num_layers=4)   # 2 pairs
        rows = np.array([[1, 1], [1, 2]], float)
        return ProbePlan((p1, p2), rows, np.array([1, cfg.num_layers // 2], float))
    if cfg.kind == "hybrid":
        per = max(cfg.attn_every, 1)
        n_chunks, tail = cfg.num_layers // per, cfg.num_layers % per
        p1 = cfg.with_(num_layers=per)          # 1 chunk, 0 tail
        p2 = cfg.with_(num_layers=2 * per)      # 2 chunks
        p3 = cfg.with_(num_layers=per + 1)      # 1 chunk, 1 tail
        rows = np.array([[1, 1, 0], [1, 2, 0], [1, 1, 1]], float)
        return ProbePlan((p1, p2, p3), rows, np.array([1, n_chunks, tail], float))
    if cfg.kind == "encdec":
        p1 = cfg.with_(encoder_layers=1, num_layers=1)
        p2 = cfg.with_(encoder_layers=2, num_layers=1)
        p3 = cfg.with_(encoder_layers=1, num_layers=2)
        rows = np.array([[1, 1, 1], [1, 2, 1], [1, 1, 2]], float)
        return ProbePlan(
            (p1, p2, p3), rows,
            np.array([1, cfg.encoder_layers or cfg.num_layers, cfg.num_layers], float),
        )
    raise ValueError(cfg.kind)


def fit_and_extrapolate(
    plan: ProbePlan, probe_costs: list[dict[str, float]]
) -> dict[str, float]:
    """Solve the linear model per metric and evaluate at the full row."""
    keys = probe_costs[0].keys()
    out = {}
    for k in keys:
        y = np.array([c[k] for c in probe_costs], float)
        coef, *_ = np.linalg.lstsq(plan.rows, y, rcond=None)
        val = float(plan.full_row @ coef)
        out[k] = max(val, 0.0)
    return out
