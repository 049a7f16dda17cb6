"""Federated dataset partitioning.

The paper's clients hold *their own* (non-identically-distributed) data; the
standard simulation device is a Dirichlet(alpha) label split (alpha -> inf is
IID, alpha -> 0 gives one-class clients).  Each client also gets an optional
covariate shift so even IID-label splits are not trivially identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .synthetic import ClassificationData


@dataclass
class ClientDataset:
    """One client's local shard + iteration state."""

    client_id: int
    x: np.ndarray
    y: np.ndarray
    _order: np.ndarray = field(init=False, repr=False)
    _pos: int = field(default=0, repr=False)
    _epoch_rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self._epoch_rng = np.random.default_rng(1000 + self.client_id)
        self._order = self._epoch_rng.permutation(len(self.y))

    def __len__(self) -> int:
        return len(self.y)

    def next_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        """Cyclic mini-batch sampler with per-epoch reshuffle."""
        idx = np.empty(batch_size, dtype=np.int64)
        filled = 0
        while filled < batch_size:
            take = min(batch_size - filled, len(self._order) - self._pos)
            idx[filled : filled + take] = self._order[self._pos : self._pos + take]
            filled += take
            self._pos += take
            if self._pos >= len(self._order):
                self._order = self._epoch_rng.permutation(len(self.y))
                self._pos = 0
        return {"x": self.x[idx], "y": self.y[idx]}

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self.y) // batch_size)


def dirichlet_partition(
    data: ClassificationData,
    *,
    n_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    min_per_client: int = 8,
) -> list[ClientDataset]:
    """Label-Dirichlet split of a classification dataset into client shards."""
    rng = np.random.default_rng(seed)
    num_classes = int(data.y.max()) + 1
    by_class = [np.flatnonzero(data.y == c) for c in range(num_classes)]
    for idxs in by_class:
        rng.shuffle(idxs)

    client_indices: list[list[int]] = [[] for _ in range(n_clients)]
    for c, idxs in enumerate(by_class):
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idxs)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idxs, cuts)):
            client_indices[cid].extend(part.tolist())

    # guarantee a floor so every client can form a batch
    all_idx = rng.permutation(len(data.y))
    floor_iter = iter(all_idx.tolist())
    for cid in range(n_clients):
        while len(client_indices[cid]) < min_per_client:
            client_indices[cid].append(next(floor_iter))

    out = []
    for cid in range(n_clients):
        sel = np.asarray(client_indices[cid], dtype=np.int64)
        rng.shuffle(sel)
        out.append(ClientDataset(client_id=cid, x=data.x[sel], y=data.y[sel]))
    return out
