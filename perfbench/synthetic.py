"""Synthetic data from a seed: copies of the port's generators
(``repro_torch.data.synthetic``), value for value, so the benchmark makes
its inputs without importing the program.

Vision: each class a low-frequency sinusoid pattern and a colour bias
(drawn from the task's fixed ``proto_seed``), plus Gaussian noise per image.
Text: each class a Markov chain over a shared vocabulary; 80% of the tokens
follow the class's preferred successors, the rest are uniform.
"""

from __future__ import annotations

import numpy as np

PROTO_SEED = 1234   # the task's class structure, shared by every split


def make_vision_dataset(num_classes: int, image_size: int, channels: int,
                        noise: float, num_samples: int, seed: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """(images (N, H, W, C) float32, labels (N,) int32)."""
    proto_rng = np.random.default_rng(PROTO_SEED)
    rng = np.random.default_rng(seed)
    h = w = image_size
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    protos = np.zeros((num_classes, h, w, channels), np.float32)
    for c in range(num_classes):
        fx, fy = proto_rng.uniform(0.5, 3.0, 2)
        phase = proto_rng.uniform(0, 2 * np.pi, 2)
        base = np.sin(2 * np.pi * fx * xx / w + phase[0]) * np.cos(
            2 * np.pi * fy * yy / h + phase[1])
        color = proto_rng.uniform(-0.8, 0.8, channels)
        protos[c] = base[..., None] * 0.6 + color[None, None, :] * 0.4
    labels = rng.integers(0, num_classes, num_samples).astype(np.int32)
    images = protos[labels] + rng.normal(0, noise, (num_samples, h, w, channels))
    return images.astype(np.float32), labels


def make_text_dataset(num_classes: int, vocab_size: int, seq_len: int,
                      num_samples: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens (N, S) int32, labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(PROTO_SEED)
    succ = proto_rng.integers(0, vocab_size, (num_classes, vocab_size, 4))
    labels = rng.integers(0, num_classes, num_samples).astype(np.int32)
    tokens = np.zeros((num_samples, seq_len), np.int32)
    tokens[:, 0] = rng.integers(0, vocab_size, num_samples)
    follow = rng.random((num_samples, seq_len)) < 0.8
    choice = rng.integers(0, 4, (num_samples, seq_len))
    rand_tok = rng.integers(0, vocab_size, (num_samples, seq_len))
    for t in range(1, seq_len):
        preferred = succ[labels, tokens[:, t - 1], choice[:, t]]
        tokens[:, t] = np.where(follow[:, t], preferred, rand_tok[:, t])
    return tokens, labels
