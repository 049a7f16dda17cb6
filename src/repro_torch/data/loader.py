"""Per-round batches for the round step, the twin of ``repro.data.loader``.

In client-parallel mode the round step consumes a *stacked* batch
``{k: (C, steps, per_client_batch, ...)}``: client axis first, then the
local-step axis the client update walks.  numpy only: the arrays are
bitwise the JAX package's, and the caller moves them to its device.
"""
from __future__ import annotations

import numpy as np

from .federated import ClientDataset


def stack_client_batches(
    clients: list[ClientDataset],
    *,
    steps: int,
    batch_size: int,
) -> dict[str, np.ndarray]:
    """Draw `steps` mini-batches from each client and stack to (C, steps, B, ...)."""
    per_client = []
    for c in clients:
        bs = [c.next_batch(batch_size) for _ in range(steps)]
        per_client.append({k: np.stack([b[k] for b in bs]) for k in bs[0]})
    return {
        k: np.stack([pc[k] for pc in per_client]) for k in per_client[0]
    }


def lm_round_batch(
    *,
    n_clients: int,
    steps: int,
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed,  # int or (experiment_seed, rnd) tuple: default_rng takes both
) -> dict[str, np.ndarray]:
    """Synthetic LM round batch (C, steps, B, seq) for the LLM-FL example."""
    from .synthetic import make_lm_tokens

    toks = make_lm_tokens(
        n_tokens=n_clients * steps * batch_size * (seq_len + 1),
        vocab_size=vocab_size,
        seed=seed,
    ).reshape(n_clients, steps, batch_size, seq_len + 1)
    return {
        "tokens": toks[..., :-1].copy(),
        "labels": toks[..., 1:].copy(),
    }
