"""Carry the JAX package's trees into the port and back.

``params_from_numpy(tree, device)`` takes a tree of numpy arrays — the JAX
package's params after ``jax.tree.map(np.asarray, params)``, float or
converted, or its AdamW state ``{"m", "v", "step"}`` — and returns the same
tree of torch tensors on ``device``.  The layouts stay the JAX package's
(dense ``w`` is ``(d_in, d_out)``, ``w_packed`` is ``(d_out, Kw)``), and
``uint32`` packed words become ``int32`` tensors holding the same bits.
A packed conv's ``shape_hwio`` (int64) stays on the host, where the packed
conv reads it without a device synchronisation.  Both packages then compute
the same thing from the same numbers.

``params_to_numpy(tree)`` is the other direction: host numpy arrays, with
the converter's packed words (leaves named ``*_packed``) viewed back as
``uint32``, as the JAX package holds them; every other leaf keeps its
dtype (the AdamW ``step`` stays ``int32``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    dev = resolve_device(device)

    def conv(node, where):
        a = np.asarray(node)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a, copy=True)).to(where)

    def rec(node, key):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, key) for v in node)
        return conv(node, "cpu" if key == "shape_hwio" else dev)

    return rec(tree, None)


def params_to_numpy(tree: Any) -> Any:
    def conv(node, packed: bool):
        if isinstance(node, dict):
            return {k: conv(v, str(k).endswith("_packed"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v, packed) for v in node)
        a = node.detach().cpu().numpy()
        return a.view(np.uint32) if packed and a.dtype == np.int32 else a

    return conv(tree, False)
