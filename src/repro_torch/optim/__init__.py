from .adam import adam, adamw, yogi
from .base import Optimizer, Schedule, chain_clip_by_global_norm, constant_schedule
from .sgd import sgd

__all__ = [
    "Optimizer",
    "Schedule",
    "adam",
    "adamw",
    "chain_clip_by_global_norm",
    "constant_schedule",
    "sgd",
    "yogi",
]
