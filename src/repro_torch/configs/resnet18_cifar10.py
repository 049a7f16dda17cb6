"""ResNet-18 on CIFAR-10 — the paper's own Jetson-TX2 workload (§5, Tables 2a/3).

Not part of the assigned transformer pool; used by the FL example
``repro_torch.examples.heterogeneous_cutoff``.
"""
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, register


@dataclass(frozen=True)
class CNNConfig:
    name: str = "resnet18-cifar10"
    stage_sizes: tuple[int, ...] = (2, 2, 2, 2)
    stage_widths: tuple[int, ...] = (64, 128, 256, 512)
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    norm: str = "groupnorm"  # BatchNorm is pathological under FedAvg

    def reduced(self) -> "CNNConfig":
        return CNNConfig(
            name=self.name + "-reduced",
            stage_sizes=(1, 1),
            stage_widths=(16, 32),
            num_classes=self.num_classes,
            image_size=self.image_size,
        )


CNN_CONFIG = CNNConfig()

# registry stub so `--arch resnet18-cifar10` resolves; transformer fields unused.
CONFIG = register(
    ArchConfig(
        name="resnet18-cifar10",
        family="cnn",
        n_layers=18,
        d_model=512,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=10,
        source="[paper §5: ResNet-18 / CIFAR-10 on Jetson TX2]",
    )
)
