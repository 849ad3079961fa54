"""ArchSpec — the registry entry every ``configs/<id>.py`` exports (a copy
of ``repro.configs.common``).

``config`` is the exact assigned architecture; ``smoke`` is the reduced
same-family variant exercised on the CPU by tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "whisper" | "cnn"
    config: Any
    smoke: Any
    supports_long: bool = False  # may run the long_500k cell
    notes: str = ""
