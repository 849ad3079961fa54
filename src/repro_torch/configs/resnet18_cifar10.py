"""Paper-native: binary ResNet-18 on CIFAR-10 (Table 1) with the 4-stage
layout used for the partial-binarization study (Table 2).

A copy of ``repro.configs.resnet18_cifar10`` in the port's config types."""

from repro_torch.configs.common import ArchSpec
from repro_torch.models.cnn import ResNet18Config

SPEC = ArchSpec(
    arch_id="resnet18-cifar10",
    family="cnn",
    config=ResNet18Config(),
    smoke=ResNet18Config(widths=(8, 8, 16, 16), in_hw=16),
)
