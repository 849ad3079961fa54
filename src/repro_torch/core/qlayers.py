"""Quantized dense layer — BMXNet's QFullyConnected, PyTorch port of
``repro.core.qlayers`` (the dense half; ``qconv`` waits for slice 5).

Two execution paths, switched by what the params dict contains:

* **fake-quant** (params have ``w``, shape ``(d_in, d_out)``): weights and
  activations are quantized with STE and contracted with ``torch.matmul``
  in ``compute_dtype``.
* **packed serving** (params have ``w_packed``: flat ``(d_out, Kw)`` int32
  sign words at 1 bit, a ``(w_bits, d_out, Kw)`` DoReFa bit-plane stack at
  2..8 bits): the contraction goes through ``kernels/dispatch.quant_gemm``,
  which owns activation quantize+pack, backend selection, pad correction
  and the k-bit dequant.  The layer's :class:`QuantSpec` carries the bit
  widths, so w4a4 / w8a8 serving needs no layer-level switch.

Both paths share ONE epilogue (scale / Eq. 2 range map / bias / cast),
built from the layer's :class:`QuantSpec` and applied by
``dispatch.apply_epilogue`` — that single implementation is what keeps the
two paths bit-exact at 1 bit (§2.2.2) and equal to fp32 rounding at k bits
(the packed k-bit dot is ``(2S - Nw*T)/(Na*Nw)``, the fake-quant one a
float matmul of the quantized values).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.core.policy import QuantSpec
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import GemmConfig

Params = dict[str, Any]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32,
               scale: float | None = None) -> Params:
    """Init a (quantizable) dense layer on ``gen``'s device.  LeCun-normal
    by default."""
    std = scale if scale is not None else d_in**-0.5
    p: Params = {"w": torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                                  device=gen.device) * std}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def qdense(params: Params, x: torch.Tensor, spec: QuantSpec, *,
           compute_dtype=torch.bfloat16,
           gemm_config: GemmConfig | None = None) -> torch.Tensor:
    """Apply a dense layer under a :class:`QuantSpec`.  Returns
    ``(..., d_out)`` in ``compute_dtype`` (the packed path returns the same
    values — exactly at 1 bit, §2.2.2; to fp32 rounding at k bits)."""
    cfg = gemm_config if gemm_config is not None else dispatch.DEFAULT_GEMM_CONFIG
    if "w_packed" in params:
        return _qdense_packed(params, x, spec, compute_dtype=compute_dtype,
                              config=cfg)
    w = params["w"]
    d_in = w.shape[0]
    bias = params.get("b")
    if spec.is_fp:
        y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
        ep = dispatch.EpilogueSpec(bias=bias is not None,
                                   out_dtype=compute_dtype)
        scale_op = None
    else:
        wq = quant.quantize_weight(w.to(torch.float32), spec.w_bits)
        xq = quant.quantize_act(x.to(torch.float32), spec.a_bits)
        y = torch.matmul(xq.to(compute_dtype), wq.to(compute_dtype))
        ep = dispatch.epilogue_from_spec(spec, bias=bias is not None,
                                         out_dtype=compute_dtype)
        scale_op = (quant.weight_scale(w)[0].to(compute_dtype)
                    if ep.scale else None)
    if bias is not None:
        bias = bias.to(compute_dtype)
    return dispatch.apply_epilogue(y, k_true=d_in, epilogue=ep,
                                   scale=scale_op, bias=bias)


def _packed_bits(params: Params, spec: QuantSpec) -> tuple[int, int]:
    """Bit widths of a packed layer, validated against its layout: 1-bit
    layers store flat (d_out, Kw) words, k-bit layers a (w_bits, d_out, Kw)
    plane stack (the converter's layouts)."""
    wp = params["w_packed"]
    if spec.is_binary and spec.a_bits == 1:
        if wp.ndim != 2:
            raise ValueError(f"1-bit packed weights must be (d_out, Kw), got "
                             f"{tuple(wp.shape)}")
        return 1, 1
    if wp.ndim != 3 or wp.shape[0] != spec.w_bits:
        raise ValueError(
            f"k-bit packed weights must be a (w_bits={spec.w_bits}, d_out, "
            f"Kw) plane stack, got {tuple(wp.shape)}")
    return spec.w_bits, spec.a_bits


def _qdense_packed(params: Params, x: torch.Tensor, spec: QuantSpec, *,
                   compute_dtype, config: GemmConfig) -> torch.Tensor:
    w_bits, a_bits = _packed_bits(params, spec)
    call = dispatch.QuantGemmCall(
        k_true=x.shape[-1],
        config=config,
        epilogue=dispatch.epilogue_from_spec(spec, bias="b" in params,
                                             out_dtype=compute_dtype),
        w_bits=w_bits,
        a_bits=a_bits,
        prologue=dispatch.prologue_from_spec(spec, config=config),
    )
    return call(x.to(torch.float32), params["w_packed"],
                scale=params.get("scale"), bias=params.get("b"))
