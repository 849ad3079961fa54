"""Paper-native: binary LeNet on MNIST (Table 1, Listing 2).

A copy of ``repro.configs.lenet_mnist`` in the port's config types."""

from repro_torch.configs.common import ArchSpec
from repro_torch.models.cnn import LeNetConfig

SPEC = ArchSpec(
    arch_id="lenet-mnist",
    family="cnn",
    config=LeNetConfig(),
    smoke=LeNetConfig(c1=8, c2=8, fc1=32, in_hw=20),
)
