"""FedBuff (Nguyen et al., 2022): buffered asynchronous aggregation.

Instead of the round ending when the slowest client reports (SyncAll) or
at a hard cutoff (Deadline), the server aggregates as soon as a buffer of
K updates has arrived; stragglers keep computing and their updates land in
a LATER aggregation, discounted by how stale they are.

- ``scheduler.BufferedAsync(K, max_staleness)`` owns the timing: which
  arrivals each round consumes, who stays in flight, who expires.
- This Strategy owns the weighting: a reported update with staleness ``s``
  aggregates at ``w_c / (1 + s)**alpha`` (``alpha=0`` is FedAvg
  weighting; Nguyen et al.'s ``1/sqrt(1+s)`` is ``alpha=0.5``).

The discount flows through ``Strategy._fit_weights``, so the grouped
compressed-wire kernel reduce and the per-client densify path apply the
same weights.  They are the first weights on ``Server.run``'s path that
are not integers.  Stale deltas apply to the CURRENT global (the wire
formats ship deltas; the Server rebases raw-parameter payloads).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import Strategy, weighted_mean


@dataclass
class FedBuffStrategy(Strategy):
    name: str = "fedbuff"
    local_epochs: int = 1
    local_lr: float = 0.05
    alpha: float = 0.5          # staleness-discount exponent
    buffer_size: int = 2        # K -- mirrored into make_policy()
    max_staleness: int = 4      # older arrivals are expired by the policy

    def fit_config(self, rnd: int, client_id: int) -> dict:
        return {"epochs": self.local_epochs, "lr": self.local_lr}

    def make_policy(self):
        """The matching scheduler policy: ONE place owns K/max_staleness."""
        from ..scheduler import BufferedAsync

        return BufferedAsync(buffer_size=self.buffer_size, max_staleness=self.max_staleness)

    def staleness_weight(self, staleness) -> float:
        return 1.0 / (1.0 + float(staleness)) ** self.alpha

    def _fit_weights(self, results, device) -> torch.Tensor:
        """Example-count weights discounted by each result's staleness: the
        Python float ``n * (1 / (1 + s) ** alpha)``, then fp32, as the JAX
        package forms it (``n * (1 + s) ** -alpha`` rounds differently).
        Results that never went through the scheduler aggregate
        undiscounted."""
        return torch.tensor(
            [
                float(r.num_examples) * self.staleness_weight(getattr(r, "staleness", 0))
                for _, r in results
            ],
            dtype=torch.float32, device=device,
        )

    def aggregate(self, client_params, weights, global_params, server_state, rnd):
        return weighted_mean(client_params, weights), server_state
