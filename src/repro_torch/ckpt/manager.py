"""Packed serving checkpoints (PyTorch port of the export half of
``repro.ckpt.manager``).

``export_packed`` runs the BMXNet model converter on a float param tree
and writes the 1-bit (or k-bit plane) serving artifact as one ``.npz`` in
the JAX package's format: keys are tree paths joined by ``|``, an empty
list leaves a ``<path>|__empty__`` marker, and packed words are ``uint32``
(``interop.params_to_numpy``), so either package loads the other's file.
``launch/serve.load_packed`` reads it back into a template tree.

``CheckpointManager`` (atomic save / validated restore / resume of the
whole train state) and the dataclass-aware flatten it needs come with the
multi-GPU train state (ROADMAP A14).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from repro_torch.core import converter
from repro_torch.interop import params_to_numpy

Pytree = Any

_SEP = "|"  # path separator safe for npz keys


def _flatten(tree: Pytree, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{i}"))
        if len(tree) == 0:
            out[f"{prefix}{_SEP}__empty__"] = np.zeros((0,))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(template: Pytree, flat: dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {
            k: _unflatten_into(v, flat,
                               f"{prefix}{_SEP}{k}" if prefix else str(k))
            for k, v in template.items()
        }
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}{_SEP}{i}")
            for i, v in enumerate(template)
        )
    return flat[prefix]


def export_packed(params: Pytree, policy, path: str) -> converter.SizeReport:
    """Run the BMXNet converter and save the packed serving checkpoint.
    Returns the SizeReport (compression accounting, paper Table 1)."""
    packed, report = converter.convert(params, policy)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(params_to_numpy(packed))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return report
