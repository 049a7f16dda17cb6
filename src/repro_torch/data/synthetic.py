"""Synthetic data sources.

CIFAR-10 / Office-31 are not available offline (DESIGN.md §7.4); we generate
*structured* synthetic data whose difficulty scales smoothly so the paper's
qualitative trends (accuracy vs E, vs C) reproduce:

- classification: Gaussian-mixture "images" — one mixture center per class,
  per-sample noise, optional per-client covariate shift (for non-IID splits).
- features: precomputed frontend embeddings for the base/head split.
- LM tokens: a learnable k-gram chain (``make_lm_tokens``) cut into
  next-token batches (``make_lm_batches``), numpy only and bitwise the JAX
  package's draws.
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


def make_lm_tokens(
    *, n_tokens: int, vocab_size: int, order: int = 2, noise: float = 0.1, seed=0
) -> np.ndarray:
    """k-gram chain: t_i = f(t_{i-1..i-k}) with prob 1-noise, uniform otherwise.

    f is a fixed random hash so a model with context >= order can reach low
    loss; pure-noise tokens bound the attainable loss from below.  ``seed``
    is anything ``np.random.default_rng`` takes (an int, or an
    ``(experiment_seed, rnd)`` tuple).
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(1, vocab_size, size=order).astype(np.int64)
    toks = np.empty(n_tokens, dtype=np.int64)
    toks[:order] = rng.integers(0, vocab_size, size=order)
    rnd = rng.random(n_tokens)
    jumps = rng.integers(0, vocab_size, size=n_tokens)
    for i in range(order, n_tokens):
        nxt = int((toks[i - order : i] * a).sum() % vocab_size)
        toks[i] = jumps[i] if rnd[i] < noise else nxt
    return toks.astype(np.int32)


def make_lm_batches(
    *,
    n_batches: int,
    batch: int,
    seq_len: int,
    vocab_size: int,
    seed=0,
) -> list[dict[str, np.ndarray]]:
    """Pre-materialized LM batches: {tokens, labels} with next-token labels."""
    stream = make_lm_tokens(
        n_tokens=n_batches * batch * (seq_len + 1), vocab_size=vocab_size, seed=seed
    )
    out = []
    per = batch * (seq_len + 1)
    for b in range(n_batches):
        chunk = stream[b * per : (b + 1) * per].reshape(batch, seq_len + 1)
        out.append({"tokens": chunk[:, :-1].copy(), "labels": chunk[:, 1:].copy()})
    return out
