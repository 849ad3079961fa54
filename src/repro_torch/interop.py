"""Load the JAX package's param trees into the port.

``params_from_numpy(tree, device)`` takes a param tree of numpy arrays — the
JAX package's params after ``jax.tree.map(np.asarray, params)``, float or
converted — and returns the same tree of torch tensors on ``device``.  The
layouts stay the JAX package's (dense ``w`` is ``(d_in, d_out)``,
``w_packed`` is ``(d_out, Kw)``), and ``uint32`` packed words become
``int32`` tensors holding the same bits.  Both packages then compute the
same thing from the same numbers.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        a = np.asarray(node)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return conv(tree)
