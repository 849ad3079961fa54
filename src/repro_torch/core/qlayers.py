"""Quantized layers — BMXNet's QFullyConnected and QConvolution, PyTorch
port of ``repro.core.qlayers``.

Two execution paths per layer, switched by what the params dict contains:

* **fake-quant** (params have ``w``: ``(d_in, d_out)`` dense, ``(h, w,
  c_in, c_out)`` HWIO conv): weights and activations are quantized with STE
  and contracted in ``compute_dtype`` — ``torch.matmul`` for dense,
  ``F.conv2d`` on NCHW views of the NHWC activations for conv (im2col plus
  ``torch.matmul`` at 1 bit, see :func:`qconv`).
* **packed serving** (params have ``w_packed``: flat ``(d_out, Kw)`` int32
  sign words at 1 bit, a ``(w_bits, d_out, Kw)`` DoReFa bit-plane stack at
  2..8 bits): the contraction goes through ``kernels/dispatch.quant_gemm``,
  which owns activation quantize+pack, backend selection, pad correction
  and the k-bit dequant.  A conv first unfolds its input into ``(h, w, C)``
  patches (im2col, the order of the HWIO weight flatten) and contracts them
  as one dense GEMM, as BMXNet implements binary conv.  The layer's
  :class:`QuantSpec` carries the bit widths, so w4a4 / w8a8 serving needs
  no layer-level switch.

Both paths share ONE epilogue (scale / Eq. 2 range map / bias / cast),
built from the layer's :class:`QuantSpec` and applied by
``dispatch.apply_epilogue`` — that single implementation is what keeps the
two paths bit-exact at 1 bit (§2.2.2) and equal to fp32 rounding at k bits
(the packed k-bit dot is ``(2S - Nw*T)/(Na*Nw)``, the fake-quant one a
float contraction of the quantized values).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# QConvolution: 2D conv for the paper-fidelity CNNs (LeNet / ResNet-18),
# NHWC activations and HWIO weights as in the JAX package.  The fake-quant
# path convolves the quantized operands; the packed path is im2col + the
# packed GEMM.
# ---------------------------------------------------------------------------


def conv_init(gen: torch.Generator, h: int, w: int, c_in: int,
              c_out: int) -> Params:
    """Init a (quantizable) fp32 HWIO conv layer on ``gen``'s device, std
    ``fan_in ** -0.5``."""
    fan_in = h * w * c_in
    return {"w": torch.randn((h, w, c_in, c_out), generator=gen,
                             dtype=torch.float32, device=gen.device)
            * fan_in**-0.5}


def qconv(params: Params, x: torch.Tensor, spec: QuantSpec, *,
          stride: int = 1, padding: str = "SAME",
          compute_dtype=torch.bfloat16,
          gemm_config: GemmConfig | None = None) -> torch.Tensor:
    """Apply a conv layer to NHWC ``x`` under a :class:`QuantSpec`
    (``padding`` ``"SAME"`` or ``"VALID"``, as ``lax.conv``).  Returns NHWC
    in ``compute_dtype``.

    At 1 bit (w1a1) the fake-quant path pads the binarized input with -1
    (bit 0) and runs im2col plus ``torch.matmul``: the ±1 sums must be exact
    integers to equal the packed path (§2.2.2), and cuDNN may pick a
    Winograd or FFT algorithm for an fp32 conv, whose transforms round.
    Every other spec runs ``F.conv2d`` with explicit zero padding (SAME at
    stride 2 splits its padding (total // 2, total - total // 2), which
    ``conv2d``'s own ``padding`` cannot express)."""
    cfg = gemm_config if gemm_config is not None else dispatch.DEFAULT_GEMM_CONFIG
    if "w_packed" in params:
        return _qconv_packed(params, x, spec, stride=stride, padding=padding,
                             compute_dtype=compute_dtype, config=cfg)
    w = params["w"]
    kh, kw, c_in, c_out = w.shape
    if spec.is_fp:
        wq, xq = w, x
    else:
        wq = quant.quantize_weight(w.to(torch.float32), spec.w_bits)
        xq = quant.quantize_act(x.to(torch.float32), spec.a_bits)
    if spec.is_binary and spec.a_bits == 1:
        if padding == "SAME":
            xq = _pad_same_pm1(xq, kh, kw, stride)
        cols, (n, oh, ow) = _im2col(xq.to(compute_dtype), kh, kw, stride,
                                    "VALID")
        y = torch.matmul(cols, wq.to(compute_dtype).reshape(-1, c_out))
        y = y.reshape(n, oh, ow, c_out)
    else:
        xq = xq.to(compute_dtype)
        if padding == "SAME":
            xq = F.pad(xq, _same_pads(xq.shape, kh, kw, stride))
        y = F.conv2d(xq.permute(0, 3, 1, 2),
                     wq.to(compute_dtype).permute(3, 2, 0, 1),
                     stride=stride).permute(0, 2, 3, 1)
    if spec.is_fp:
        ep = dispatch.EpilogueSpec(out_dtype=compute_dtype)
        scale_op = None
    else:
        ep = dispatch.epilogue_from_spec(spec, bias=False,
                                         out_dtype=compute_dtype)
        scale_op = (w.abs().mean(dim=(0, 1, 2)).to(compute_dtype)
                    if ep.scale else None)
    return dispatch.apply_epilogue(y, k_true=kh * kw * c_in, epilogue=ep,
                                   scale=scale_op)


def _same_pads(shape, h: int, w: int, stride: int) -> tuple[int, ...]:
    """``F.pad`` widths (C, W, H from the last dim) of SAME geometry on an
    NHWC ``shape``: total padding ``(out - 1) * stride + k - in``, split
    ``(total // 2, total - total // 2)`` as XLA splits it."""
    _, xh, xw, _ = shape
    oh, ow = -(-xh // stride), -(-xw // stride)
    ph = max((oh - 1) * stride + h - xh, 0)
    pw = max((ow - 1) * stride + w - xw, 0)
    return (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)


def _pad_same_pm1(x: torch.Tensor, h: int, w: int,
                  stride: int) -> torch.Tensor:
    """SAME-geometry padding with -1 (the binary pad value, bit 0)."""
    return F.pad(x, _same_pads(x.shape, h, w, stride), value=-1.0)


def _im2col(x: torch.Tensor, h: int, w: int, stride: int, padding: str):
    """(N, H, W, C) -> ((N*OH*OW, h*w*C) patches, (N, OH, OW)), each patch
    in ``(h, w, C)`` order, the order of the HWIO weight flatten.  SAME pads
    with -1.0 (bit 0 at 1 bit; code 0 after the k-bit clip), so the packed
    path sees the fake-quant path's patches."""
    if padding == "SAME":
        x = _pad_same_pm1(x, h, w, stride)
    n, c = x.shape[0], x.shape[3]
    p = x.unfold(1, h, stride).unfold(2, w, stride)  # (N, OH, OW, C, h, w)
    oh, ow = p.shape[1], p.shape[2]
    cols = p.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, h * w * c)
    return cols, (n, oh, ow)


def _qconv_packed(params: Params, x: torch.Tensor, spec: QuantSpec, *,
                  stride: int, padding: str, compute_dtype,
                  config: GemmConfig) -> torch.Tensor:
    # shape_hwio lives on the host (converter, interop): reading it costs
    # no device synchronisation
    h, w, c_in, c_out = (int(v) for v in params["shape_hwio"].tolist())
    w_bits, a_bits = _packed_bits(params, spec)
    cols, (n, oh, ow) = _im2col(x.to(torch.float32), h, w, stride, padding)
    call = dispatch.QuantGemmCall(
        k_true=h * w * c_in,
        config=config,
        epilogue=dispatch.epilogue_from_spec(spec, bias=False,
                                             out_dtype=compute_dtype),
        w_bits=w_bits,
        a_bits=a_bits,
        prologue=dispatch.prologue_from_spec(spec, config=config),
    )
    dot = call(cols, params["w_packed"], scale=params.get("scale"))
    return dot.reshape(n, oh, ow, c_out)
