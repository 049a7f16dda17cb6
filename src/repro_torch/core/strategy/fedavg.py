"""FedAvg (McMahan et al., 2017) — the paper's default Strategy.

``aggregate`` is the python-side hook ``aggregate_fit`` uses after
densifying raw payloads; a compressed-wire fleet reduces on the kernels
and ``server_update`` is the identity (the weighted average IS the new
global).
"""
from __future__ import annotations

from dataclasses import dataclass

from .base import Strategy, weighted_mean


@dataclass
class FedAvg(Strategy):
    name: str = "fedavg"
    local_epochs: int = 1
    local_lr: float = 0.05

    def fit_config(self, rnd: int, client_id: int) -> dict:
        return {"epochs": self.local_epochs, "lr": self.local_lr}

    def aggregate(self, client_params, weights, global_params, server_state, rnd):
        return weighted_mean(client_params, weights), server_state
