"""The operation and byte counters against counts by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench.kernelcounts import masked_adam_launch
from perfbench.manifest import load_module

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "perfbench" / "configs"


def _config(name, **override):
    cfg = json.loads((CONFIGS / name / "config.json").read_text())
    cfg.update(override)
    ref = load_module(CONFIGS / name / "reference.py", f"test_ref_{name.replace('-', '_')}")
    counts = load_module(CONFIGS / name / "counts.py", f"test_counts_{name.replace('-', '_')}")
    return cfg, ref, counts


def test_nlp_block_forward_is_1835008_per_token():
    cfg, ref, counts = _config("nlp-transformer")
    fwd = counts.step(cfg, ref, None).forward
    head = 2 * 256 * 4
    assert (fwd - head) / (cfg["seq_len"] * cfg["num_layers"]) == 1_835_008
    assert fwd == pytest.approx(1.879e9, rel=1e-3)


def test_nlp_full_step_is_three_forwards():
    """Every product's operands need gradients when the embedding trains."""
    cfg, ref, counts = _config("nlp-transformer")
    full = counts.step(cfg, ref, frozenset(range(ref.num_groups(cfg))))
    assert full.total == 3 * full.forward


def test_nlp_partial_steps_by_hand():
    cfg, ref, counts = _config("nlp-transformer")
    s, d, ff = 256, 256, 1024
    proj, scores, mlp = 2 * s * d * d, 2 * s * s * d, 2 * s * d * ff
    fwd = counts.step(cfg, ref, None).forward
    head = 2 * d * 4
    # the head: its norm trains, so the classifier's input needs a gradient
    # as well as its weight
    assert counts.step(cfg, ref, frozenset({5})).total == fwd + 2 * head
    # the last block: its first norm trains, so every product of the block
    # is taken both ways; the frozen head passes its input gradient down
    last = 2 * 3 * proj + 2 * 2 * scores + 2 * proj + 2 * 2 * mlp + head
    assert counts.step(cfg, ref, frozenset({4})).total == fwd + last
    # one block above the trained one: input gradients only, the attention
    # products both ways
    above = 4 * proj + 2 * 2 * scores + 2 * mlp
    assert counts.step(cfg, ref, frozenset({3})).total == fwd + last + above


def test_tiny_resnet_by_hand():
    """Stages [1, 1] at 8 / 16 channels on 8 x 8 images, 10 classes."""
    cfg, ref, counts = _config("resnet18", stages=[1, 1], channels=[8, 16],
                               num_classes=10, image_size=8)
    stem = 2 * 9 * 3 * 8 * 64
    b0 = 2 * (2 * 9 * 8 * 8 * 64)
    b1_conv1, b1_conv2, b1_sc = 2 * 9 * 8 * 16 * 16, 2 * 9 * 16 * 16 * 16, 2 * 8 * 16 * 16
    head = 2 * 16 * 10
    fwd = stem + b0 + b1_conv1 + b1_conv2 + b1_sc + head
    assert counts.step(cfg, ref, None).forward == fwd == 290_112
    # full: the stem's input is data, so no gradient of the images
    full = counts.step(cfg, ref, frozenset(range(ref.num_groups(cfg))))
    assert full.total == 3 * fwd - stem
    # the last conv2 group: its weight gradient, then the head's input gradient
    assert counts.step(cfg, ref, frozenset({4})).total == fwd + b1_conv2 + head


def test_resnet18_forward():
    cfg, ref, counts = _config("resnet18")
    assert counts.step(cfg, ref, None).forward == pytest.approx(1.11e9, rel=1e-2)
    assert ref.num_groups(cfg) == 18
    assert sum(lf.numel for lf in ref.leaves(cfg)) == cfg["params"]


def test_masked_adam_bytes():
    cfg, ref, _ = _config("nlp-transformer")
    leaves = ref.leaves(cfg)
    assert sum(lf.numel for lf in leaves) == cfg["params"] == 10_902_020
    blocks = sum(-(-lf.numel // 1024) for lf in leaves)
    nbytes, ops = masked_adam_launch(leaves, -1, 8)
    assert nbytes == 8 * (10_902_020 * 28 + 4 * blocks)
    assert ops == 8 * 10_902_020 * 14
    head = 256 + 256 + 256 * 4 + 4
    assert masked_adam_launch(leaves, 5, 1)[0] == head * 28 + 4 * blocks


def test_masked_adam_skips_batchnorm_moments():
    cfg, ref, _ = _config("resnet18")
    leaves = ref.leaves(cfg)
    stats = sum(lf.numel for lf in leaves if lf.local_stat)
    assert stats > 0
    trained = cfg["params"] - stats
    blocks = sum(-(-lf.numel // 1024) for lf in leaves)
    assert masked_adam_launch(leaves, -1, 1)[0] == trained * 28 + 4 * blocks
