#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written Hopper kernels from the sources in this
checkout, holds each against its plain PyTorch version, times them, and
serves granite-3-2b at full width through the continuous-batching
scheduler on those kernels, packed 1-bit and packed DoReFa w4a4.

    python3 chip_smoke.py            # needs one CUDA GPU (sm_90a) and nvcc

Phases (any failure exits non-zero before the result line):

1. environment: the card's name and power limit, torch / CUDA versions,
   the kernel build (time and the compiler's register report);
2. kernel parity, exact int32, at the main path's GEMM shapes (decode batch
   and prefill rows) and ragged ones: sign-pack (K1), xnor-popcount (K2)
   and int8-unpack (K3) against their plain versions; quantize-plane-pack
   (K4) with rounding ties and range edges, plane AND-popcount (K5) and
   code-lane ``mma`` (K6) against theirs, and K5 == K6, at plane counts
   (2,2), (4,4), (8,8) and (8,4);
3. timing: each kernel, its plain version and one PyTorch yardstick call
   (bf16 ``torch.matmul`` of the ±1 operands for K2/K3, of the dequantized
   DoReFa operands for K5/K6; none for K1/K4) at the main-path shapes,
   w4a4 and w8a8 for K4-K6, with the least time the card could take
   (``bound_ms``: for a GEMM, that of its function, the integer dot of the
   codes, on the int8 tensor cores, whichever kernel computes it; K2/K5's
   popcount ceiling is printed beside it);
4. serving: granite-3-2b at full width (d_model 2048, 32/8 heads, d_ff 8192,
   vocab 49155 padded to 49408), all 40 layers, params from a seeded
   ``torch.Generator`` on the card, 8 requests of mixed prompt length on 4
   slots, each run with its kernel counts set to 0 just before it and read
   just after:
   - 1-bit (``QuantPolicy.binary()``): packed ``vpu``, packed ``mxu`` and
     fake-quant; the greedy streams must be identical (paper §2.2.2);
   - w4a4 (``QuantPolicy.quantized(4)``): packed ``vpu`` (-> vpu-k4),
     packed ``mxu`` (-> mxu-k4) and fake-quant; the ``vpu`` and ``mxu``
     streams must be identical (the same integer S, the same dequant);
     agreement with fake-quant is measured and reported, not gated, since
     the k-bit contract is fp32-allclose per GEMM, where one activation
     code at a rounding tie may flip over 40 layers;
   - on layer 0's real weights and one prefill's activations, each of the
     seven packed ``qdense`` outputs must equal fake-quant within
     ``rtol=1e-4, atol=2e-4`` at w4a4 and at w8a8;
   and each kernel's launch count in its serving run must be > 0;
5. the ``kernels`` JSON line, then the result line.

Per-shape timings, the serving runs and the decode profiles also go to
``build/chip_smoke.json`` (git-ignored).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8 tensor cores
POPC_PER_SM_PER_CLK = 16  # CUDA C++ Programming Guide throughput table, cc 9.0

# granite-3-2b's packed GEMMs, (name, N, K), in the order a layer runs them
LAYER_GEMMS = (("q", 2048, 2048), ("k", 512, 2048), ("v", 512, 2048),
               ("o", 2048, 2048), ("up", 8192, 2048), ("gate", 8192, 2048),
               ("down", 2048, 8192))
DECODE_M = 4  # serving batch
PREFILL_M = 4 * 64  # a full admission group of 64-token prompts
PROMPT_LENS = (16, 16, 64, 32, 48, 48, 64, 16)
NEW_TOKENS = 16
CACHE_LEN = 256
SEED = 0

KBIT_TOL = dict(rtol=1e-4, atol=2e-4)  # the JAX package's k-bit contract
PLANE_PAIRS = ((2, 2), (4, 4), (8, 8), (8, 4))  # (ka, kb)

KERNELS = {
    "pack_sign": ("src/repro_torch/csrc/pack_sign.cu",
                  "src/repro/kernels/pack_bits.py:84"),
    "xnor_mismatch": ("src/repro_torch/csrc/xnor_mismatch.cu",
                      "src/repro/kernels/xnor_gemm.py:139"),
    "xnor_dot_mxu": ("src/repro_torch/csrc/xnor_dot_mxu.cu",
                     "src/repro/kernels/xnor_gemm.py:158"),
    "quant_pack_planes": ("src/repro_torch/csrc/quant_pack_planes.cu",
                          "src/repro/kernels/pack_bits.py:135"),
    "kbit_plane_gemm": ("src/repro_torch/csrc/kbit_plane_gemm.cu",
                        "src/repro/kernels/kbit_gemm.py:138"),
    "kbit_mxu_gemm": ("src/repro_torch/csrc/kbit_mxu_gemm.cu",
                      "src/repro/kernels/kbit_mxu.py:205"),
}
ONE_BIT = ("pack_sign", "xnor_mismatch", "xnor_dot_mxu")
K_BIT = ("quant_pack_planes", "kbit_plane_gemm", "kbit_mxu_gemm")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def edge_floats(shape, gen, dev):
    """Normal floats with the sign edge cases (+0, -0, NaN, ±inf) mixed in."""
    x = torch.randn(shape, generator=gen, device=dev)
    flat = x.view(-1)
    edge = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                         -float("inf")], device=dev)
    idx = torch.randint(0, flat.numel(), (5,), generator=gen, device=dev)
    flat[idx] = edge
    return x


# --------------------------------------------------------------------------
# phase 2: parity
# --------------------------------------------------------------------------


def parity(dev) -> dict[str, float]:
    from repro_torch.kernels import pack_bits, xnor_gemm

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(m, n, k) for _, n, k in LAYER_GEMMS
             for m in (1, 3, DECODE_M, 128, PREFILL_M)]
    cases += [(m, n, k) for m in (1, 3, 128) for n, k in ((2047, 2049),
                                                          (513, 8191), (65, 33))]
    err = {name: 0.0 for name in ONE_BIT}
    for m, n, k in cases:
        x = edge_floats((m, k), gen, dev)
        w = edge_floats((n, k), gen, dev)
        xp, wp = pack_bits.pack_sign(x), pack_bits.pack_sign(w)
        pairs = {
            "pack_sign": [(xp, pack_bits.pack_sign_plain(x)),
                          (wp, pack_bits.pack_sign_plain(w))],
            "xnor_mismatch": [(xnor_gemm.xnor_mismatch(xp, wp),
                               xnor_gemm.xnor_mismatch_plain(xp, wp))],
            "xnor_dot_mxu": [(xnor_gemm.xnor_dot_mxu(xp, wp),
                              xnor_gemm.xnor_dot_mxu_plain(xp, wp))],
        }
        torch.cuda.synchronize()
        check_exact(pairs, err, f"M={m} N={n} K={k}")
    print(f"parity: {len(cases)} shapes, K1-K3 equal their plain versions "
          f"exactly (int32)")
    return err


def check_exact(pairs: dict, err: dict, where: str) -> None:
    """Every (kernel, plain) result pair must agree exactly; records the
    max |err| per kernel name."""
    for name, results in pairs.items():
        for got, want in results:
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} at {where}: {got.shape}/"
                                     f"{got.dtype} vs {want.shape}/"
                                     f"{want.dtype}")
            e = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
            err[name] = max(err[name], e)
            if e != 0:
                raise AssertionError(f"{name} != plain at {where}: max "
                                     f"|err| {e}")


def dorefa_acts(shape, gen, dev, a_bits: int):
    """Floats over [-0.5, 1.5] with the DoReFa edge cases mixed in: the
    rounding ties (j + 0.5)/Na, -0.0, 0, 1, below 0 and above 1."""
    x = torch.rand(shape, generator=gen, device=dev) * 2 - 0.5
    na = (1 << a_bits) - 1
    edge = torch.tensor([(j + 0.5) / na for j in range(na)]
                        + [-0.0, 0.0, 1.0, -3.0, 7.0, 1e-8], device=dev)
    flat = x.view(-1)
    idx = torch.randperm(flat.numel(), generator=gen, device=dev)
    n = min(flat.numel() // 2, edge.numel())
    flat[idx[:n]] = edge[:n]
    return x


def weight_planes(n: int, k: int, w_bits: int, gen, dev) -> torch.Tensor:
    """A (w_bits, N, Kw) plane stack of DoReFa codes of normal weights, as
    the converter packs them."""
    from repro_torch.core import bitpack, quant

    w = torch.randn((n, k), generator=gen, device=dev)
    return bitpack.pack_planes(quant.weight_codes(w, w_bits), w_bits)


def parity_kbit(dev) -> dict[str, float]:
    from repro_torch.kernels import kbit_gemm, kbit_mxu, pack_bits

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    err = {name: 0.0 for name in K_BIT}
    n_k4 = 0
    for m in (1, 3, DECODE_M, 128, PREFILL_M):
        for k in (2048, 8192, 2049, 8191, 33):
            for a_bits in (2, 3, 4, 8):
                x = dorefa_acts((m, k), gen, dev, a_bits)
                got = pack_bits.quant_pack_planes(x, a_bits)
                want = pack_bits.quant_pack_planes_plain(x, a_bits)
                torch.cuda.synchronize()
                check_exact({"quant_pack_planes": list(zip(got, want))}, err,
                            f"M={m} K={k} a_bits={a_bits}")
                n_k4 += 1
    cases = [(m, n, k) for _, n, k in LAYER_GEMMS for m in (1, DECODE_M,
                                                           PREFILL_M)]
    cases += [(m, n, k) for m in (1, 3, 128) for n, k in ((2047, 2049),
                                                          (513, 8191), (65, 33))]
    for m, n, k in cases:
        for ka, kb in PLANE_PAIRS:
            ap, _ = pack_bits.quant_pack_planes(
                dorefa_acts((m, k), gen, dev, ka), ka)
            wp = weight_planes(n, k, kb, gen, dev)
            s5 = kbit_gemm.kbit_plane_gemm(ap, wp)
            s6 = kbit_mxu.kbit_mxu_gemm(ap, wp)
            want = kbit_gemm.kbit_plane_gemm_plain(ap, wp)
            torch.cuda.synchronize()
            check_exact({"kbit_plane_gemm": [(s5, want)],
                         "kbit_mxu_gemm": [(s6, kbit_mxu.kbit_mxu_gemm_plain(
                             ap, wp)), (s6, s5)]}, err,
                        f"M={m} N={n} K={k} ka={ka} kb={kb}")
    print(f"parity: K4 at {n_k4} (M, K, a_bits) cases, K5/K6 at "
          f"{len(cases)} shapes x {len(PLANE_PAIRS)} plane pairs: equal to "
          f"their plain versions and K5 == K6, exactly (int32)")
    return err


# --------------------------------------------------------------------------
# phase 3: timing
# --------------------------------------------------------------------------


def graph_ms(fn, arg_sets, iters: int, reps: int = 5) -> float:
    """Median device time of one call: ``iters`` calls (cycling through
    ``arg_sets``) captured in one CUDA graph, replayed ``reps`` times
    between CUDA events — the host's launch cost is not in the number."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def copies_for(nbytes: int, cap: int) -> int:
    """Distinct weight copies to cycle through so that they overflow the
    50 MB L2 cache: the serving path reads every layer's weights cold."""
    return max(2, min(cap, math.ceil(128e6 / nbytes)))


def operands(bits: int, m: int, n: int, k: int, copies: int, gen, dev):
    """Activations ``x`` (M, K), their packed form, ``copies`` distinct
    packed weights (N rows), and the yardstick's bf16 operands: the values
    the packed GEMM contracts, dequantized, (M, K) and (K, N)."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import pack_bits

    if bits == 1:
        x = torch.randn((m, k), generator=gen, device=dev)
        xp = pack_bits.pack_sign(x)
        ws = [pack_bits.pack_sign(torch.randn((n, k), generator=gen,
                                              device=dev))
              for _ in range(copies)]
        xq = torch.where(x >= 0, 1.0, -1.0)
        codes = bitpack.unpack_bits(ws[0], k)
    else:
        x = dorefa_acts((m, k), gen, dev, bits)
        xp, _ = pack_bits.quant_pack_planes(x, bits)
        ws = [weight_planes(n, k, bits, gen, dev) for _ in range(copies)]
        na = float((1 << bits) - 1)
        xq = torch.round(x.clamp(0, 1) * na) / na
        codes = bitpack.unpack_planes(ws[0], k)
    nw = float((1 << bits) - 1)
    wq = (2 * codes.to(torch.float32) - nw) / nw  # ±1 at 1 bit
    return (x, xp, ws, xq.to(torch.bfloat16),
            wq.T.contiguous().to(torch.bfloat16))


# kernels timed at each width: the activation prologue, then the popcount
# GEMM and the tensor-core GEMM, which compute the same integer function
FAMILIES = {1: ONE_BIT, 4: K_BIT, 8: K_BIT}


def timing(dev, popc_per_s: float) -> tuple[dict, list]:
    """Every kernel at the decode and prefill rows of each layer GEMM, 1-bit
    (K1-K3), w4a4 and w8a8 (K4-K6): kernel, plain version, the bf16
    yardstick and the bound.  A GEMM's function is the integer dot of the
    codes, so its bound is the larger of its bytes at the HBM rate and
    ``2*M*N*K`` int8 operations at the tensor cores' peak, whichever kernel
    computes it; the popcount kernels (K2, K5) also get the ceiling of their
    own algorithm at the popc rate (``popc_bound_ms``).  The plain K5 runs
    ka*kb int64 popcount passes (about a second per prefill call at w8a8),
    so plain versions at prefill are timed once."""
    from repro_torch.kernels import kbit_gemm, kbit_mxu, pack_bits, xnor_gemm

    fns = {  # name: (kernel, plain version)
        "pack_sign": (pack_bits.pack_sign, pack_bits.pack_sign_plain),
        "xnor_mismatch": (xnor_gemm.xnor_mismatch,
                          xnor_gemm.xnor_mismatch_plain),
        "xnor_dot_mxu": (xnor_gemm.xnor_dot_mxu, xnor_gemm.xnor_dot_mxu_plain),
        "quant_pack_planes": (pack_bits.quant_pack_planes,
                              pack_bits.quant_pack_planes_plain),
        "kbit_plane_gemm": (kbit_gemm.kbit_plane_gemm,
                            kbit_gemm.kbit_plane_gemm_plain),
        "kbit_mxu_gemm": (kbit_mxu.kbit_mxu_gemm, kbit_mxu.kbit_mxu_gemm_plain),
    }
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []
    for bits, (pro, popc_gemm, mma_gemm) in FAMILIES.items():
        for m in (DECODE_M, PREFILL_M):
            plain_iters, plain_reps = (4, 5) if m == DECODE_M else (1, 1)
            for name, n, k in LAYER_GEMMS:
                kw = (k + 31) // 32
                nw = copies_for(bits * n * kw * 4, 512)
                x, xp, wps, xb, wb = operands(bits, m, n, k, min(nw, 4), gen,
                                              dev)
                wps = [wps[i % len(wps)].clone() for i in range(nw)]
                nl = copies_for(n * k * 2, 64)
                wbs = [wb.clone() for _ in range(nl)]
                del wb
                row = {"bits": bits, "m": m, "layer": name, "n": n, "k": k}
                # the prologue reads x and writes the words (and, at k bits,
                # the code row-sums)
                args = (x,) if bits == 1 else (x, bits)
                row[pro] = dict(
                    ms=graph_ms(fns[pro][0], [args], 200),
                    plain_ms=graph_ms(fns[pro][1], [args], 5),
                    library_ms=None,
                    bytes=(m * k + bits * m * kw + (m if bits > 1 else 0)) * 4,
                    ops_s=0.0)
                lib_ms = graph_ms(torch.matmul, [(xb, w) for w in wbs], nl)
                for kname in (popc_gemm, mma_gemm):
                    kernel, plain = fns[kname]
                    row[kname] = dict(
                        ms=graph_ms(kernel, [(xp, w) for w in wps], nw),
                        plain_ms=graph_ms(plain, [(xp, w) for w in wps[:4]],
                                          plain_iters, reps=plain_reps),
                        library_ms=lib_ms,
                        bytes=(bits * m * kw + bits * n * kw + m * n) * 4,
                        ops_s=2 * m * n * k / INT8_OPS_PER_S)
                row[popc_gemm]["popc_bound_ms"] = (
                    bits * bits * m * n * kw / popc_per_s * 1e3)
                finish_row(row, FAMILIES[bits],
                           f"timing w{bits}a{bits} M={m} {name} N={n} K={k}")
                rows.append(row)
                del wps, wbs
    return decode_layer_totals(rows), rows


def finish_row(row: dict, names, label: str) -> None:
    """Add each kernel's bound (the larger of its bytes at the HBM rate and
    its operations at their peak) and print the row."""
    for kname in names:
        r = row[kname]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S
        r["bound_ms"] = max(t_bytes, r["ops_s"]) * 1e3
        r["bound_by"] = "bytes" if t_bytes >= r["ops_s"] else "operations"
    print(f"{label} (us): " + "; ".join(
        f"{kn} kernel {row[kn]['ms'] * 1e3:.3f} plain "
        f"{row[kn]['plain_ms'] * 1e3:.3f} library "
        + ("-" if row[kn]["library_ms"] is None
           else f"{row[kn]['library_ms'] * 1e3:.3f}")
        + f" bound {row[kn]['bound_ms'] * 1e3:.3f}"
        + ("" if "popc_bound_ms" not in row[kn]
           else f" popc ceiling {row[kn]['popc_bound_ms'] * 1e3:.3f}")
        for kn in names))


def decode_layer_totals(rows: list) -> dict:
    """The JSON line's numbers: one decode step of one layer (the 7 GEMMs'
    calls at M = batch), summed per kernel; K4-K6 at w4a4."""
    totals = {}
    for kname in KERNELS:
        rs = [r[kname] for r in rows
              if r["m"] == DECODE_M and r["bits"] in (1, 4) and kname in r]
        t_bytes = sum(r["bytes"] for r in rs) / HBM_BYTES_PER_S
        t_ops = sum(r["ops_s"] for r in rs)
        lib = [r["library_ms"] for r in rs]
        totals[kname] = dict(
            ms=sum(r["ms"] for r in rs),
            plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if None in lib else sum(lib))
    return totals


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------


def serve_mix(spec, cfg, policy, runs_spec, prompts, tag: str):
    """Serve ``prompts`` once per (label, params, backend) in ``runs_spec``
    under ``policy``; the kernel counts are set to 0 just before each run
    and read just after.  Returns (runs, launches) keyed by label."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.nn.common import QCtx
    from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                          Scheduler)

    ecfg = EngineConfig(batch=DECODE_M, cache_len=CACHE_LEN,
                        max_new_tokens=NEW_TOKENS)
    runs, launches = {}, {}
    for label, p, backend in runs_spec:
        ctx = QCtx(policy=policy, compute_dtype=torch.float32,
                   gemm_config=GemmConfig(backend=backend))
        eng = Engine(spec, cfg, ctx, p, ecfg)
        sched = Scheduler(eng)
        for pr in prompts:
            sched.submit(Request(prompt=pr))
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[label] = dict(_cuda.LAUNCHES)
        n_tok = sum(len(v) for v in results.values())
        tpot = statistics.median(sched.stats.tpots()) * 1e3
        runs[label] = dict(results=results, seconds=dt, tokens=n_tok,
                           tok_s=n_tok / dt, decode_ms_step=tpot,
                           steps=sched.stats.steps,
                           prefills=sched.stats.prefills)
        print(f"serving {tag}{label}: {n_tok} tokens in {dt:.4f}s = "
              f"{n_tok / dt:.3f} tok/s; decode {tpot:.4f} ms/step (median "
              f"inter-token gap); {sched.stats.steps} decode steps, "
              f"{sched.stats.prefills} prefills; launches "
              f"{ {k: v for k, v in launches[label].items() if v} }")
        runs[label]["decode_profile"] = profile_decode(eng, tag + label)
    ref = runs["fake-quant"]["results"]
    if sorted(ref) != list(range(len(prompts))):
        raise AssertionError(f"{tag}missing requests: {sorted(ref)}")
    for rid, toks in ref.items():
        if len(toks) != NEW_TOKENS or not ((toks >= 0)
                                           & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{tag}rid {rid}: bad stream {toks}")
    return runs, launches


def serving(dev) -> tuple[dict, dict]:
    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.launch.serve import stream_agreement
    from repro_torch.models import lm, registry
    from repro_torch.nn.common import QCtx

    spec = registry.get("granite-3-2b")
    cfg = spec.config
    widths = (cfg.d_model, cfg.attn.n_heads, cfg.attn.n_kv_heads,
              cfg.attn.d_head, cfg.mlp.d_ff, cfg.vocab_size, cfg.padded_vocab)
    if widths != (2048, 32, 8, 64, 8192, 49155, 49408):
        raise AssertionError(f"granite-3-2b widths changed: {widths}")
    binary, w4a4 = QuantPolicy.binary(), QuantPolicy.quantized(4)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), cfg)
    packed, report = converter.convert(params, binary)
    torch.cuda.synchronize()
    print(f"serving: granite-3-2b full width, depth {cfg.n_layers} of 40 "
          f"layers; init + convert {time.perf_counter() - t0:.3f}s; "
          f"1-bit {report.summary()}")
    t0 = time.perf_counter()
    packed4, report4 = converter.convert(params, w4a4)
    torch.cuda.synchronize()
    print(f"serving: w4a4 convert {time.perf_counter() - t0:.3f}s; "
          f"{report4.summary()}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]

    # logits of one prompt are finite, of the padded shape, pad-masked
    for pol, p in ((binary, packed), (w4a4, packed4)):
        ctx = QCtx(policy=pol, compute_dtype=torch.float32,
                   gemm_config=GemmConfig(backend="vpu"))
        with torch.inference_mode():
            logits, _ = lm.prefill(p, cfg, ctx, torch.as_tensor(
                prompts[0][None], dtype=torch.long, device=dev), CACHE_LEN)
        if (logits.shape != (1, 1, cfg.padded_vocab)
                or not torch.isfinite(logits[..., :cfg.vocab_size]).all()
                or not (logits[..., cfg.vocab_size:] == -1e30).all()):
            raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")

    layer0 = layer0_gemms(dev, cfg, params, prompts)

    runs, launches = serve_mix(
        spec, cfg, binary, (("packed-vpu", packed, "vpu"),
                            ("packed-mxu", packed, "mxu"),
                            ("fake-quant", params, "vpu")), prompts, "")
    ref = runs["fake-quant"]["results"]
    for label in ("packed-vpu", "packed-mxu"):
        for rid in ref:
            if not np.array_equal(runs[label]["results"][rid], ref[rid]):
                raise AssertionError(
                    f"§2.2.2 violated: {label} rid {rid} "
                    f"{runs[label]['results'][rid]} != fake-quant {ref[rid]}")
    print("serving: greedy streams identical for packed-vpu, packed-mxu and "
          "fake-quant (§2.2.2)")
    lv, lm_, lf = (launches[k] for k in ("packed-vpu", "packed-mxu",
                                          "fake-quant"))
    if not (lv["pack_sign"] > 0 and lv["xnor_mismatch"] > 0
            and lv["xnor_dot_mxu"] == 0 and lm_["pack_sign"] > 0
            and lm_["xnor_dot_mxu"] > 0 and lm_["xnor_mismatch"] == 0
            and not any(lf.values())):
        raise AssertionError(f"1-bit path did not run through the kernels: "
                             f"{launches}")
    del packed

    runs4, launches4 = serve_mix(
        spec, cfg, w4a4, (("packed-vpu", packed4, "vpu"),
                          ("packed-mxu", packed4, "mxu"),
                          ("fake-quant", params, "vpu")), prompts, "w4a4 ")
    rv, rm = runs4["packed-vpu"]["results"], runs4["packed-mxu"]["results"]
    for rid in rv:
        if not np.array_equal(rv[rid], rm[rid]):
            raise AssertionError(f"w4a4 rid {rid}: vpu stream {rv[rid]} != "
                                 f"mxu stream {rm[rid]}")
    agreement = {}
    for label in ("packed-vpu", "packed-mxu"):
        same, total, first = stream_agreement(
            runs4[label]["results"], runs4["fake-quant"]["results"])
        agreement[label] = dict(tokens_agree=same, tokens=total,
                                first_difference=first)
    print(f"serving w4a4: packed-vpu and packed-mxu greedy streams identical;"
          f" against fake-quant (measured, not gated): {agreement}")
    lv, lm_, lf = (launches4[k] for k in ("packed-vpu", "packed-mxu",
                                           "fake-quant"))
    if not (lv["quant_pack_planes"] > 0 and lv["kbit_plane_gemm"] > 0
            and lv["kbit_mxu_gemm"] == 0 and lm_["quant_pack_planes"] > 0
            and lm_["kbit_mxu_gemm"] > 0 and lm_["kbit_plane_gemm"] == 0
            and not any(lf.values())
            and not any(lv[n] or lm_[n] for n in ONE_BIT)):
        raise AssertionError(f"w4a4 path did not run through the kernels: "
                             f"{launches4}")
    main_launches = {"pack_sign": launches["packed-vpu"]["pack_sign"],
                     "xnor_mismatch": launches["packed-vpu"]["xnor_mismatch"],
                     "xnor_dot_mxu": launches["packed-mxu"]["xnor_dot_mxu"],
                     "quant_pack_planes":
                         launches4["packed-vpu"]["quant_pack_planes"],
                     "kbit_plane_gemm":
                         launches4["packed-vpu"]["kbit_plane_gemm"],
                     "kbit_mxu_gemm": launches4["packed-mxu"]["kbit_mxu_gemm"]}
    summary = {tag + k: {kk: vv for kk, vv in v.items() if kk != "results"}
               for tag, rs in (("", runs), ("w4a4 ", runs4))
               for k, v in rs.items()}
    summary["w4a4 agreement with fake-quant"] = agreement
    summary["layer0 packed vs fake-quant"] = layer0
    return main_launches, summary


def recording_ctx(policy, backend: str, keep, inputs: dict):
    """A float32 ``QCtx`` whose ``dense`` also stores, under its path, the
    input of every GEMM whose path ``keep`` accepts."""
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.nn.common import QCtx

    class RecordingQCtx(QCtx):
        def dense(self, p, x, path):
            if keep(path):
                inputs[path] = x.detach().clone()
            return super().dense(p, x, path)

    return RecordingQCtx(policy=policy, compute_dtype=torch.float32,
                         gemm_config=GemmConfig(backend=backend))


def prefill_tokens(prompts, dev) -> torch.Tensor:
    """The longest prompt of the mix as a (1, S) batch."""
    prompt = next(p for p in prompts if len(p) == max(PROMPT_LENS))
    return torch.as_tensor(prompt[None], dtype=torch.long, device=dev)


def layer0_gemms(dev, cfg, params, prompts) -> dict:
    """Each of layer 0's seven GEMMs, on its real weights and the inputs one
    fake-quant prefill gives it: packed ``qdense`` (``vpu`` and ``mxu``)
    must equal fake-quant ``qdense`` within the k-bit contract, at w4a4 and
    w8a8.  Both are also held (reported, not gated) against the exact
    DoReFa dot — the integer codes' values ``n_a/Na`` and
    ``(2*n_w - Nw)/Nw`` contracted in float64 — which says which side the
    difference comes from."""
    from repro_torch.core import converter, qlayers, quant
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.models import lm

    inputs = {}
    out = {}
    for bits in (4, 8):
        policy = QuantPolicy.quantized(bits)
        inputs.clear()
        ctx = recording_ctx(policy, "vpu",
                            lambda path: path.startswith("layers/0/"), inputs)
        with torch.inference_mode():
            lm.prefill(params, cfg, ctx, prefill_tokens(prompts, dev),
                       CACHE_LEN)
        layer = params["layers"][0]
        packed, _ = converter.convert({"layers": [layer]}, policy)
        if len(inputs) != 7:
            raise AssertionError(f"layer 0 GEMMs seen: {sorted(inputs)}")
        for path, x in sorted(inputs.items()):
            _, _, blk, name = path.split("/")
            spec_q = policy.spec(path)
            p = layer[blk][name]
            n = float((1 << bits) - 1)
            with torch.inference_mode():
                exact = ((quant.act_codes(x, bits).double() / n)
                         @ ((2 * quant.weight_codes(p["w"], bits).double()
                             - n) / n))
                if "b" in p:
                    exact = exact + p["b"].double()
            for backend in ("vpu", "mxu"):
                cfg_g = GemmConfig(backend=backend)
                with torch.inference_mode():
                    want = qlayers.qdense(p, x, spec_q,
                                          compute_dtype=torch.float32,
                                          gemm_config=cfg_g)
                    got = qlayers.qdense(packed["layers"][0][blk][name], x,
                                         spec_q, compute_dtype=torch.float32,
                                         gemm_config=cfg_g)
                diff = (got - want).abs()
                limit = KBIT_TOL["atol"] + KBIT_TOL["rtol"] * want.abs()
                key = f"w{bits}a{bits} {name} {backend}"
                out[key] = dict(
                    max_abs_err=float(diff.max()),
                    worst_over_limit=float((diff / limit).max()),
                    rows=int(x.numel() // x.shape[-1]),
                    packed_vs_exact=float((got.double() - exact).abs().max()),
                    fakequant_vs_exact=float(
                        (want.double() - exact).abs().max()))
                if not bool((diff <= limit).all()):
                    raise AssertionError(f"layer 0 {key}: packed != fake-"
                                         f"quant within {KBIT_TOL}: "
                                         f"{out[key]}")
    worst = max(v["worst_over_limit"] for v in out.values())
    print(f"layer 0: {len(out)} packed qdense outputs (7 GEMMs x w4a4/w8a8 x "
          f"vpu/mxu, {max(PROMPT_LENS)} prefill rows) within {KBIT_TOL} of "
          f"fake-quant; largest |err| / limit {worst:.4f}; max |err| "
          f"{max(v['max_abs_err'] for v in out.values()):.3e}; against the "
          f"exact DoReFa dot (float64): packed max |err| "
          f"{max(v['packed_vs_exact'] for v in out.values()):.3e}, "
          f"fake-quant {max(v['fakequant_vs_exact'] for v in out.values()):.3e}")
    return out


def profile_decode(eng, label: str, steps: int = 3) -> dict:
    """Where one decode step's time goes: wall time of ``steps`` plain
    decode steps (batch 4, all 256 cache rows attended), and the device time
    of the same steps under ``torch.profiler`` (kernels only, by name).  The
    device busy share is device time over unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = eng.ecfg.batch
    tok = torch.zeros((b, 1), dtype=torch.long, device=eng.device)
    pos = torch.arange(b, dtype=torch.int32, device=eng.device)
    cache = eng.init_cache()
    with torch.inference_mode():
        for _ in range(2):
            eng._decode(cache, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._decode(cache, tok, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng._decode(cache, tok, pos)
            torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", 0.0)
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / steps
    device_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms if by_name else None,
           "device_busy_share": device_ms / wall_ms if by_name else None,
           "top_kernels_us_per_step": [[k[:90], v] for k, v in top]}
    if not by_name:
        print(f"profile {label}: wall {wall_ms:.4f} ms/step; device time "
              "not measured (the profiler recorded no device events)")
    else:
        print(f"profile {label}: wall {wall_ms:.4f} ms/step, device "
              f"{device_ms:.4f} ms/step, busy share {device_ms / wall_ms:.4f};"
              " top: " + "; ".join(f"{k[:60]} {v:.1f}us" for k, v in top))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run this "
              "script from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device
    from repro_torch.kernels import _cuda

    dev = resolve_device("cuda")
    print(nvidia_smi("name,power.limit"))
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_per_s = sms * POPC_PER_SM_PER_CLK * clock_mhz * 1e6
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {sms} SMs, max SM clock "
          f"{clock_mhz} MHz")
    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.lib()
    print(f"kernels built in {time.perf_counter() - t0:.3f}s -> "
          f"{so.relative_to(ROOT)}")
    print(so.with_suffix(".log").read_text().strip())

    t0 = time.perf_counter()
    err = parity(dev)
    err.update(parity_kbit(dev))
    print(f"parity phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    totals, rows = timing(dev, popc_per_s)
    print(f"timing phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    launches, serve_summary = serving(dev)
    print(f"serving phase {time.perf_counter() - t0:.3f}s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "device": nvidia_smi("name,power.limit"), "timing_rows": rows,
        "kernel_totals_decode_layer (K4-K6 at w4a4)": totals,
        "serving": serve_summary,
        "launches": launches}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        sys.exit(1)
