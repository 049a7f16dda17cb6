from .base import Optimizer, Schedule, chain_clip_by_global_norm, constant_schedule
from .sgd import sgd

# Adam and Yogi arrive with the FedOpt strategies (ROADMAP.md queue 1 item 7)

__all__ = [
    "Optimizer",
    "Schedule",
    "chain_clip_by_global_norm",
    "constant_schedule",
    "sgd",
]
