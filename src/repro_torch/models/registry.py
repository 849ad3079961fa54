"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers and tests.  This slice knows granite-3-2b only."""

from __future__ import annotations

from repro_torch.configs import granite_3_2b
from repro_torch.configs.common import ArchSpec

ARCHS: dict[str, ArchSpec] = {m.SPEC.arch_id: m.SPEC for m in (granite_3_2b,)}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
