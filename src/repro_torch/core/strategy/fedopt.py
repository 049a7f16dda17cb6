"""FedOpt family (Reddi et al., 2021): server-side adaptive optimizers.

The aggregated client average becomes a pseudo-gradient consumed by a
server optimizer (momentum / Adam / Yogi).  The optimizer's moments are
the strategy's server state: ``init_state`` builds them on the params'
device, ``Strategy._server_state_for`` carries them across
``aggregate_fit`` rounds, and the round engine threads them through
``server_update``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.optim import adam, sgd, yogi
from repro_torch.utils.pytree import tree_map

from .base import Strategy, pseudo_gradient


@dataclass
class FedOpt(Strategy):
    name: str = "fedopt"
    local_epochs: int = 1
    local_lr: float = 0.05
    server_opt: str = "adam"       # "sgdm" | "adam" | "yogi"
    server_lr: float = 0.1
    server_momentum: float = 0.9

    def _opt(self):
        if self.server_opt == "sgdm":
            return sgd(self.server_lr, momentum=self.server_momentum)
        if self.server_opt == "yogi":
            return yogi(self.server_lr)
        return adam(self.server_lr, b1=0.9, b2=0.99)

    def fit_config(self, rnd: int, client_id: int) -> dict:
        return {"epochs": self.local_epochs, "lr": self.local_lr}

    def init_state(self, global_params):
        return self._opt().init(global_params)

    def aggregate(self, client_params, weights, global_params, server_state, rnd):
        g = pseudo_gradient(client_params, weights, global_params)
        with torch.no_grad():
            return self._opt().update(g, global_params, server_state, rnd)

    def server_update(self, avg_params, global_params, server_state, rnd):
        g = tree_map(
            lambda gp, ap: gp.to(torch.float32) - ap.to(torch.float32),
            global_params, avg_params,
        )
        with torch.no_grad():
            return self._opt().update(g, global_params, server_state, rnd)


def FedAdam(**kw) -> FedOpt:
    return FedOpt(name="fedadam", server_opt="adam", **kw)


def FedYogi(**kw) -> FedOpt:
    return FedOpt(name="fedyogi", server_opt="yogi", **kw)


def FedAvgM(**kw) -> FedOpt:
    return FedOpt(name="fedavgm", server_opt="sgdm", **kw)
