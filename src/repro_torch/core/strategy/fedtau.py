"""FedTau -- the paper's modified FedAvg with a hardware-specific cutoff.

Each client gets a wall-clock budget tau (FitIns config); when tau expires
it ships whatever parameters it has, even mid-epoch (paper §5, Table 3).
Flower's cost quantification lets the server set tau_CPU = the round time
of the GPU fleet, equalizing round walls at a small accuracy cost.

In simulation the cutoff maps to a per-client step budget through the cost
model (steps_i = floor(tau / step_time_i)), shipped as ``max_steps``; the
round engine takes the same budgets as its ``step_budgets``.  FedTau
composes with per-device codec selection (``Strategy.codec_policy``).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..cost_model import CostModel
from .base import Strategy, weighted_mean


@dataclass
class FedTau(Strategy):
    name: str = "fedtau"
    local_epochs: int = 5
    local_lr: float = 0.05
    tau_s: float = 0.0                    # 0 = no cutoff (paper notation)
    cost_model: CostModel | None = None
    steps_per_epoch: int = 10

    def round_deadline_s(self) -> float | None:
        """tau IS the scheduler's deadline: ``scheduler.Deadline(tau=None)``
        cuts the virtual round at the same instant that budgets the local
        steps.  The ``max_steps`` budget is compute-only; the
        ``deadline_s`` a Deadline policy ships lets clients with known
        profiles subtract their own transfer time."""
        return self.tau_s if self.tau_s > 0 else None

    def fit_config(self, rnd: int, client_id: int) -> dict:
        cfg = {"epochs": self.local_epochs, "lr": self.local_lr, "tau_s": self.tau_s}
        if self.cost_model is not None:
            full = self.local_epochs * self.steps_per_epoch
            cfg["max_steps"] = self.cost_model.steps_under_tau(client_id, self.tau_s, full)
        return cfg

    def client_step_budgets(self, client_ids) -> list[int]:
        full = self.local_epochs * self.steps_per_epoch
        if self.cost_model is None or self.tau_s <= 0:
            return [full for _ in client_ids]
        return [self.cost_model.steps_under_tau(cid, self.tau_s, full) for cid in client_ids]

    def aggregate(self, client_params, weights, global_params, server_state, rnd):
        return weighted_mean(client_params, weights), server_state


def tau_from_reference_processor(
    cost_model: CostModel, reference_profile: str, *, epochs: int, steps_per_epoch: int
) -> float:
    """Paper Table 3: set tau to the reference (GPU) fleet's full round time."""
    return cost_model.tau_for_profile(
        reference_profile, epochs=epochs, steps_per_epoch=steps_per_epoch
    )
