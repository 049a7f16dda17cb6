"""Synthetic data sources.

CIFAR-10 / Office-31 are not available offline (DESIGN.md §7.4); we generate
*structured* synthetic data whose difficulty scales smoothly so the paper's
qualitative trends (accuracy vs E, vs C) reproduce:

- classification: Gaussian-mixture "images" — one mixture center per class,
  per-sample noise, optional per-client covariate shift (for non-IID splits).
- features: precomputed frontend embeddings for the base/head split.

The LM token stream comes with the transformer family (ROADMAP.md queue 1
item 15).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ClassificationData:
    x: np.ndarray  # (N, ...) float32
    y: np.ndarray  # (N,) int32

    def __len__(self) -> int:
        return len(self.y)


def make_classification(
    *,
    n: int,
    num_classes: int,
    shape: tuple[int, ...],
    noise: float = 1.0,
    seed: int = 0,
    class_sep: float = 2.0,
) -> ClassificationData:
    """Gaussian mixture with one center per class in flattened pixel space."""
    rng = np.random.default_rng(seed)
    dim = int(np.prod(shape))
    centers = rng.normal(0.0, class_sep / np.sqrt(dim), size=(num_classes, dim))
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = centers[y] + rng.normal(0.0, noise / np.sqrt(dim), size=(n, dim))
    return ClassificationData(
        x=x.reshape((n, *shape)).astype(np.float32), y=y
    )


def make_features(
    *, n: int, num_classes: int, feature_dim: int, noise: float = 0.6, seed: int = 0
) -> ClassificationData:
    """Frozen-base features for the head model (paper §4.1 Android workload)."""
    return make_classification(
        n=n, num_classes=num_classes, shape=(feature_dim,), noise=noise, seed=seed
    )
