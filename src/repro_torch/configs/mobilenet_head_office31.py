"""MobileNetV2-base + 2-layer head on Office-31 — the paper's Android workload (§4.1, Table 2b).

The frozen MobileNetV2 base is a feature extractor producing 1280-d features
(the paper freezes it and ports it via TFLite); faithful to that design, the
base here is a fixed random-projection feature stub and FL trains only the
2-layer DNN head — exactly the paper's Model-Personalization split.
"""
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, register


@dataclass(frozen=True)
class HeadConfig:
    name: str = "mobilenet-head-office31"
    feature_dim: int = 1280     # MobileNetV2 penultimate features
    hidden_dim: int = 256       # 2-layer DNN head (paper §5)
    num_classes: int = 31       # Office-31

    def reduced(self) -> "HeadConfig":
        return HeadConfig(name=self.name + "-reduced", feature_dim=64, hidden_dim=32)


HEAD_CONFIG = HeadConfig()

CONFIG = register(
    ArchConfig(
        name="mobilenet-head-office31",
        family="head",
        n_layers=2,
        d_model=256,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=31,
        source="[paper §4.1/§5: MobileNetV2 base + 2-layer head, Office-31]",
    )
)
