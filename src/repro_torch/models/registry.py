"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers and tests — the dense granite-3-2b, deepseek-7b and qwen2-72b,
the MoE deepseek-moe-16b and qwen2-moe-a2.7b (family ``lm``), and the
paper's binary CNNs lenet-mnist and resnet18-cifar10 (family ``cnn``:
trained and evaluated by
``launch/binary_mnist`` and ``launch/partial_binarization``; the serving
``Engine`` and the LM trainer take the ``lm`` family only)."""

from __future__ import annotations

from repro_torch.configs import (deepseek_7b, deepseek_moe_16b, granite_3_2b,
                                 lenet_mnist, qwen2_72b, qwen2_moe_a27b,
                                 resnet18_cifar10)
from repro_torch.configs.common import ArchSpec

ARCHS: dict[str, ArchSpec] = {
    m.SPEC.arch_id: m.SPEC
    for m in (granite_3_2b, deepseek_7b, qwen2_72b, deepseek_moe_16b,
              qwen2_moe_a27b, lenet_mnist, resnet18_cifar10)}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
