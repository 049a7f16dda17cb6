from .base import Strategy, pseudo_gradient, weighted_mean
from .fedavg import FedAvg
from .fedbuff import FedBuffStrategy
from .fedopt import FedAdam, FedAvgM, FedOpt, FedYogi
from .fedprox import FedProx
from .fedtau import FedTau, tau_from_reference_processor

# the JAX package's "costaware-fedavg" (strategy/sampling.py) samples a
# packed Population: it arrives with population mode, ROADMAP.md queue 1
# item 10
STRATEGIES = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "fedtau": FedTau,
    "fedbuff": FedBuffStrategy,
    "fedadam": FedAdam,
    "fedyogi": FedYogi,
    "fedavgm": FedAvgM,
}

__all__ = [
    "Strategy", "weighted_mean", "pseudo_gradient",
    "FedAvg", "FedProx", "FedTau", "tau_from_reference_processor",
    "FedBuffStrategy", "FedOpt", "FedAdam", "FedYogi", "FedAvgM", "STRATEGIES",
]
