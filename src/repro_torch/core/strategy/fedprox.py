"""FedProx (Li et al., 2018): proximal client objective + partial work.

The paper cites FedProx as the algorithmic relative of its tau-cutoff
mechanism ("accepts partial results from clients").  The client loss gains
mu/2 * ||w - w_global||^2 (``TorchClient`` adds it when ``fit_config``
ships ``mu``); aggregation is FedAvg over whatever (possibly partial)
updates arrive.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.utils.pytree import tree_sq_norm, tree_sub

from .base import Strategy, weighted_mean


@dataclass
class FedProx(Strategy):
    name: str = "fedprox"
    local_epochs: int = 1
    local_lr: float = 0.05
    mu: float = 0.01

    def fit_config(self, rnd: int, client_id: int) -> dict:
        return {"epochs": self.local_epochs, "lr": self.local_lr, "mu": self.mu}

    def client_loss_extra(self, params, global_params):
        return 0.5 * self.mu * tree_sq_norm(tree_sub(params, global_params))

    def aggregate(self, client_params, weights, global_params, server_state, rnd):
        return weighted_mean(client_params, weights), server_state
