from .base import Strategy, weighted_mean
from .fedavg import FedAvg

# FedProx, FedTau, FedOpt, FedBuff and cost-aware sampling arrive with
# ROADMAP.md queue 1 item 7

__all__ = ["Strategy", "weighted_mean", "FedAvg"]
