"""Datasets (numpy only; a copy of ``repro.data.datasets``'s image task
and synthetic token stream, producing arrays identical to it for the
same seed).

CIFAR-10 is never downloaded; it is replaced by a
*synthetic CIFAR-10-shaped* task: 10 classes, 3@32x32 images built from
per-class low-frequency templates + structured noise. It is genuinely
learnable (a linear probe gets ~60%, VGG-5 >95%), so accuracy-parity
experiments (paper Fig. 4) are meaningful. Sizes mirror CIFAR-10
(50k train / 10k test) but are scalable for quick tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)


def _class_templates(rng: np.random.Generator) -> np.ndarray:
    """Smooth per-class templates: random low-frequency Fourier images."""
    freqs = 4
    tmpl = np.zeros((NUM_CLASSES, *IMAGE_SHAPE), np.float32)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    for c in range(NUM_CLASSES):
        img = np.zeros((32, 32, 3), np.float32)
        for _ in range(freqs):
            fy, fx = rng.uniform(0.5, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 3)
            amp = rng.uniform(0.5, 1.0, 3)
            for ch in range(3):
                img[..., ch] += amp[ch] * np.sin(
                    2 * np.pi * (fy * yy + fx * xx) / 32 + ph[ch])
        tmpl[c] = img / freqs
    return tmpl


@dataclass
class ImageDataset:
    images: np.ndarray   # (N, 32, 32, 3) float32
    labels: np.ndarray   # (N,) int32

    def __len__(self) -> int:
        return len(self.labels)

    def subset(self, idx: np.ndarray) -> "ImageDataset":
        return ImageDataset(self.images[idx], self.labels[idx])


def synthetic_cifar10(n_train: int = 50_000, n_test: int = 10_000,
                      noise: float = 0.6, seed: int = 0
                      ) -> Tuple[ImageDataset, ImageDataset]:
    rng = np.random.default_rng(seed)
    tmpl = _class_templates(rng)

    def make(n):
        labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
        images = tmpl[labels] + noise * rng.standard_normal(
            (n, *IMAGE_SHAPE)).astype(np.float32)
        # per-sample random brightness/shift augmentation-like variation
        images += rng.uniform(-0.2, 0.2, (n, 1, 1, 3)).astype(np.float32)
        return ImageDataset(images.astype(np.float32), labels)

    return make(n_train), make(n_test)


def synthetic_tokens(batch: int, seq_len: int, vocab: int, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic token stream (next-token predictable above
    chance) for LLM train and serve steps."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int64)
    # introduce local structure: 50% of tokens repeat with +1 shift
    rep = rng.random((batch, seq_len)) < 0.5
    base[:, 1:][rep] = (base[:, :-1][rep] + 1) % vocab
    return {"tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32)}
