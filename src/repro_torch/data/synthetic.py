"""Synthetic datasets (nothing is downloaded — no CIFAR/TinyImageNet).

A numpy-only copy of ``repro.data.synthetic``, value-identical for the same
seeds (the port imports nothing of the JAX package).

Vision: class-conditional images built from per-class low-frequency pattern +
per-class color statistics + noise.  The task is learnable (a linear probe
fails, a small CNN succeeds) so convergence-speed comparisons between FNU
and FedPart are meaningful — the paper's *directional* claims are validated
on it (EXPERIMENTS.md records the caveat).

Text: token sequences from class-dependent Markov chains over a shared
vocabulary — a classification task matching the paper's AGNews/SogouNews
setup in spirit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VisionDatasetSpec:
    num_classes: int = 20
    image_size: int = 32
    channels: int = 3
    noise: float = 0.35
    proto_seed: int = 1234      # class prototypes are a property of the TASK:
    name: str = "synth-cifar"   # train/eval splits share them (sample seed differs)


def _draw_labels(rng: np.random.Generator, num_classes: int, num_samples: int,
                 class_probs=None) -> np.ndarray:
    """Uniform labels (the default, bit-identical to the historical stream)
    or ``class_probs``-weighted ones — per-client label skew for populations
    whose shards are synthesized from (seed, client_id) rather than
    partitioned from one global array (``fl.population``)."""
    if class_probs is None:
        return rng.integers(0, num_classes, num_samples).astype(np.int32)
    p = np.asarray(class_probs, dtype=np.float64)
    if p.shape != (num_classes,):
        raise ValueError(f"class_probs shape {p.shape} != ({num_classes},)")
    return rng.choice(num_classes, size=num_samples, p=p / p.sum()).astype(np.int32)


def make_vision_dataset(
    spec: VisionDatasetSpec, num_samples: int, seed: int = 0,
    class_probs=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,H,W,C) float32 in [-1,1], labels (N,) int32)."""
    proto_rng = np.random.default_rng(spec.proto_seed)
    rng = np.random.default_rng(seed)
    h = w = spec.image_size
    # Per-class pattern: mixture of low-frequency sinusoids + color bias —
    # drawn from the spec's proto_seed so every split sees the same task.
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    protos = np.zeros((spec.num_classes, h, w, spec.channels), np.float32)
    for c in range(spec.num_classes):
        fx, fy = proto_rng.uniform(0.5, 3.0, 2)
        phase = proto_rng.uniform(0, 2 * np.pi, 2)
        base = np.sin(2 * np.pi * fx * xx / w + phase[0]) * np.cos(
            2 * np.pi * fy * yy / h + phase[1]
        )
        color = proto_rng.uniform(-0.8, 0.8, spec.channels)
        protos[c] = base[..., None] * 0.6 + color[None, None, :] * 0.4

    labels = _draw_labels(rng, spec.num_classes, num_samples, class_probs)
    images = protos[labels] + rng.normal(0, spec.noise, (num_samples, h, w, spec.channels))
    return images.astype(np.float32), labels


@dataclasses.dataclass(frozen=True)
class TextDatasetSpec:
    num_classes: int = 4
    vocab_size: int = 512
    seq_len: int = 64
    proto_seed: int = 1234
    name: str = "synth-agnews"


def make_text_dataset(
    spec: TextDatasetSpec, num_samples: int, seed: int = 0,
    class_probs=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Class-dependent Markov chains: (tokens (N,S) int32, labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    # Per-class transition structure (task-level: shared across splits).
    proto_rng = np.random.default_rng(spec.proto_seed)
    succ = proto_rng.integers(0, spec.vocab_size, (spec.num_classes, spec.vocab_size, 4))
    labels = _draw_labels(rng, spec.num_classes, num_samples, class_probs)
    tokens = np.zeros((num_samples, spec.seq_len), np.int32)
    tokens[:, 0] = rng.integers(0, spec.vocab_size, num_samples)
    follow = rng.random((num_samples, spec.seq_len)) < 0.8
    choice = rng.integers(0, 4, (num_samples, spec.seq_len))
    rand_tok = rng.integers(0, spec.vocab_size, (num_samples, spec.seq_len))
    for t in range(1, spec.seq_len):
        preferred = succ[labels, tokens[:, t - 1], choice[:, t]]
        tokens[:, t] = np.where(follow[:, t], preferred, rand_tok[:, t])
    return tokens, labels
