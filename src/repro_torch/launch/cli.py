"""The launchers' shared flag blocks (PyTorch port of ``repro.launch.cli``).

``launch/serve.py`` takes its GEMM, attention and speculative-decoding flags
from here, so the spelling and the defaults live in one place; the parsed
backend always lands on ``args.gemm_backend``.

Not in the port yet: the tensor-parallel ``shard-*`` backends with
``--shard`` / ``--shard-layout``, and ``--capacity-factor`` (the
expert-parallel MoE path); they wait for multi-GPU (ROADMAP A14).
"""

from __future__ import annotations

import argparse

from repro_torch.kernels.dispatch import GemmConfig, backend_names


def add_gemm_flags(ap: argparse.ArgumentParser, *names: str) -> None:
    """The GEMM execution block.  ``names`` are the backend flag's
    spellings (the first canonical, the rest aliases); its choices are the
    dispatch registry's backends, its default ``vpu``."""
    ap.add_argument(*names, dest="gemm_backend", default="vpu",
                    choices=backend_names(),
                    help="base GEMM backend; k-bit layers resolve vpu / mxu "
                         "onto the vpu-k* / mxu-k* plane kernels")
    ap.add_argument("--jnp-prologue", action="store_true",
                    help="quantize and pack activations with the plain "
                         "bitpack / quant reference instead of the prologue "
                         "kernels (the equivalence oracle; slower)")


def add_attn_flags(ap: argparse.ArgumentParser) -> None:
    """The decode-attention execution and KV storage block.  ``--fused-attn``
    swaps the gather + masked-sdpa path for the flash-decode kernel, which
    reads the KV storage in place; ``--kv-bits`` picks the storage tier."""
    ap.add_argument("--fused-attn", action="store_true",
                    help="route decode/window attention through the fused "
                         "flash-decode kernel (no dense KV gather); off = "
                         "the gather + masked-sdpa oracle path")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8, 1],
                    help="KV-cache storage tier: 8 = int8 codes + per-"
                         "(head, dh-group) absmax scales, 1 = sign bytes + "
                         "per-head alpha (the XNOR tier); default fp "
                         "compute dtype")


def add_spec_flags(ap: argparse.ArgumentParser) -> None:
    """The speculative-decoding block.  ``--draft`` derives a depth-sliced
    draft from the seeded float model (``converter.derive_draft``): ``w1a1``
    binarizes it onto the packed 1-bit GEMMs, ``fp`` keeps it float.
    Greedy output equals non-speculative serving either way."""
    ap.add_argument("--draft", default=None, choices=["w1a1", "fp"],
                    help="enable speculative decoding with a depth-sliced "
                         "draft: 'w1a1' binarizes the slice (1-bit packed "
                         "GEMMs), 'fp' keeps it float; greedy outputs stay "
                         "token-identical to non-speculative serving")
    ap.add_argument("--spec-len", type=int, default=2,
                    help="proposed tokens per speculative round (the target "
                         "verifies spec_len + 1 positions in one window)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="leading layers kept in the draft slice (default "
                         "n_layers // 4, at least 1)")


def gemm_config_from_args(args: argparse.Namespace) -> GemmConfig:
    """A GemmConfig from the flags :func:`add_gemm_flags` installed."""
    return GemmConfig(backend=args.gemm_backend,
                      fused_prologue=not args.jnp_prologue)
