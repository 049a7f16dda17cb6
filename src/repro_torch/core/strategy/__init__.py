from .base import Strategy, pseudo_gradient, weighted_mean
from .fedavg import FedAvg
from .fedbuff import FedBuffStrategy
from .fedopt import FedAdam, FedAvgM, FedOpt, FedYogi
from .fedprox import FedProx
from .fedtau import FedTau, tau_from_reference_processor
from .sampling import CostAwareFedAvg, CostAwareSampling

STRATEGIES = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "fedtau": FedTau,
    "fedbuff": FedBuffStrategy,
    "fedadam": FedAdam,
    "fedyogi": FedYogi,
    "fedavgm": FedAvgM,
    "costaware-fedavg": CostAwareFedAvg,
}

__all__ = [
    "Strategy", "weighted_mean", "pseudo_gradient",
    "FedAvg", "FedProx", "FedTau", "tau_from_reference_processor",
    "FedBuffStrategy", "FedOpt", "FedAdam", "FedYogi", "FedAvgM", "STRATEGIES",
    "CostAwareSampling", "CostAwareFedAvg",
]
