#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written Hopper kernels from the sources in this
checkout, holds each against its plain PyTorch version, times them, and
serves granite-3-2b at full width through the continuous-batching
scheduler on those kernels.

    python3 chip_smoke.py            # needs one CUDA GPU (sm_90a) and nvcc

Phases (any failure exits non-zero before the result line):

1. environment: the card's name and power limit, torch / CUDA versions,
   the kernel build (time and the compiler's register report);
2. kernel parity: sign-pack (K1), xnor-popcount (K2) and int8-unpack (K3)
   against their plain versions, exact int32, at the main path's GEMM
   shapes (decode batch and prefill rows) and ragged ones;
3. timing: each kernel, its plain version and one PyTorch yardstick call
   (bf16 ``torch.matmul`` of the ±1 operands for K2/K3) at the main-path
   shapes, with the least time the card could take (``bound_ms``);
4. serving: granite-3-2b at full width (d_model 2048, 32/8 heads, d_ff 8192,
   vocab 49155 padded to 49408), params from a seeded ``torch.Generator``
   on the card, converted to packed words, 8 requests of mixed prompt
   length on 4 slots, served packed with ``vpu``, packed with ``mxu`` and
   fake-quant; the greedy streams must be identical (paper §2.2.2), and
   each kernel's launch count in its serving run must be > 0;
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

KERNELS = {
    "pack_sign": ("src/repro_torch/csrc/pack_sign.cu",
                  "src/repro/kernels/pack_bits.py:84"),
    "xnor_mismatch": ("src/repro_torch/csrc/xnor_mismatch.cu",
                      "src/repro/kernels/xnor_gemm.py:139"),
    "xnor_dot_mxu": ("src/repro_torch/csrc/xnor_dot_mxu.cu",
                     "src/repro/kernels/xnor_gemm.py:158"),
}


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
    err = {name: 0.0 for name in KERNELS}
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
        for name, results in pairs.items():
            for got, want in results:
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{name} at M={m} N={n} K={k}: "
                                         f"{got.shape}/{got.dtype} vs "
                                         f"{want.shape}/{want.dtype}")
                e = float((got.long() - want.long()).abs().max())
                err[name] = max(err[name], e)
                if e != 0:
                    raise AssertionError(f"{name} != plain at M={m} N={n} "
                                         f"K={k}: max |err| {e}")
    print(f"parity: {len(cases)} shapes, K1-K3 equal their plain versions "
          f"exactly (int32)")
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


def timing(dev, popc_per_s: float) -> tuple[dict, list]:
    from repro_torch.kernels import pack_bits, xnor_gemm

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []
    for m in (DECODE_M, PREFILL_M):
        for name, n, k in LAYER_GEMMS:
            kw = (k + 31) // 32
            x = torch.randn((m, k), generator=gen, device=dev)
            xp = pack_bits.pack_sign(x)
            nw = copies_for(n * kw * 4, 512)
            wps = [pack_bits.pack_sign(torch.randn((n, k), generator=gen,
                                                   device=dev))
                   for _ in range(min(nw, 8))]
            wps = [wps[i % len(wps)].clone() for i in range(nw)]
            xb = torch.where(x >= 0, 1.0, -1.0).to(torch.bfloat16)
            nl = copies_for(n * k * 2, 64)
            wbs = [torch.randn((k, n), generator=gen, device=dev).sign()
                   .to(torch.bfloat16) for _ in range(nl)]
            io_bytes = (m * kw + n * kw + m * n) * 4
            row = {"m": m, "layer": name, "n": n, "k": k}
            # K1: this layer's activation pack (reads x, writes words)
            row["pack_sign"] = dict(
                ms=graph_ms(pack_bits.pack_sign, [(x,)], 200),
                plain_ms=graph_ms(pack_bits.pack_sign_plain, [(x,)], 5),
                library_ms=None, bytes=(m * k + m * kw) * 4, ops=0,
                bound_ops_s=0.0)
            for kname, fn, plain, ops, rate in (
                    ("xnor_mismatch", xnor_gemm.xnor_mismatch,
                     xnor_gemm.xnor_mismatch_plain, m * n * kw, popc_per_s),
                    ("xnor_dot_mxu", xnor_gemm.xnor_dot_mxu,
                     xnor_gemm.xnor_dot_mxu_plain, 2 * m * n * kw * 32,
                     INT8_OPS_PER_S)):
                row[kname] = dict(
                    ms=graph_ms(fn, [(xp, w) for w in wps], nw),
                    plain_ms=graph_ms(plain, [(xp, w) for w in wps[:4]], 4),
                    library_ms=graph_ms(torch.matmul, [(xb, w) for w in wbs],
                                        nl),
                    bytes=io_bytes, ops=ops, bound_ops_s=ops / rate)
            for kname in KERNELS:
                r = row[kname]
                t_bytes = r["bytes"] / HBM_BYTES_PER_S
                r["bound_ms"] = max(t_bytes, r["bound_ops_s"]) * 1e3
                r["bound_by"] = ("bytes" if t_bytes >= r["bound_ops_s"]
                                 else "operations")
            rows.append(row)
            print(f"timing M={m} {name} N={n} K={k} (us): " + "; ".join(
                f"{kn} kernel {row[kn]['ms'] * 1e3:.3f} plain "
                f"{row[kn]['plain_ms'] * 1e3:.3f} library "
                + ("-" if row[kn]["library_ms"] is None
                   else f"{row[kn]['library_ms'] * 1e3:.3f}")
                + f" bound {row[kn]['bound_ms'] * 1e3:.3f}"
                for kn in KERNELS))
    # the JSON line: one decode step of one layer (7 calls each, M = batch)
    totals = {}
    for kname in KERNELS:
        rs = [r[kname] for r in rows if r["m"] == DECODE_M]
        t_bytes = sum(r["bytes"] for r in rs) / HBM_BYTES_PER_S
        t_ops = sum(r["bound_ops_s"] for r in rs)
        lib = [r["library_ms"] for r in rs]
        totals[kname] = dict(
            ms=sum(r["ms"] for r in rs),
            plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if None in lib else sum(lib))
    return totals, rows


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------


def serving(dev) -> tuple[dict, dict]:
    import dataclasses

    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.models import lm, registry
    from repro_torch.nn.common import QCtx
    from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                          Scheduler)

    spec = registry.get("granite-3-2b")
    cfg = spec.config
    widths = (cfg.d_model, cfg.attn.n_heads, cfg.attn.n_kv_heads,
              cfg.attn.d_head, cfg.mlp.d_ff, cfg.vocab_size, cfg.padded_vocab)
    if widths != (2048, 32, 8, 64, 8192, 49155, 49408):
        raise AssertionError(f"granite-3-2b widths changed: {widths}")
    policy = QuantPolicy.binary()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), cfg)
    packed, report = converter.convert(params, policy)
    torch.cuda.synchronize()
    print(f"serving: granite-3-2b full width, depth {cfg.n_layers} of 40 "
          f"layers; init + convert {time.perf_counter() - t0:.3f}s; "
          f"{report.summary()}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    ecfg = EngineConfig(batch=DECODE_M, cache_len=CACHE_LEN,
                        max_new_tokens=NEW_TOKENS)
    base = QCtx(policy=policy, compute_dtype=torch.float32)

    # logits of one prompt are finite, of the padded shape, pad-masked
    ctx = dataclasses.replace(base, gemm_config=GemmConfig(backend="vpu"))
    with torch.inference_mode():
        logits, _ = lm.prefill(packed, cfg, ctx, torch.as_tensor(
            prompts[0][None], dtype=torch.long, device=dev), CACHE_LEN)
    if (logits.shape != (1, 1, cfg.padded_vocab)
            or not torch.isfinite(logits[..., :cfg.vocab_size]).all()
            or not (logits[..., cfg.vocab_size:] == -1e30).all()):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")

    runs, launches = {}, {}
    for label, p, backend in (("packed-vpu", packed, "vpu"),
                              ("packed-mxu", packed, "mxu"),
                              ("fake-quant", params, "vpu")):
        ctx = dataclasses.replace(base, gemm_config=GemmConfig(backend=backend))
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
        print(f"serving {label}: {n_tok} tokens in {dt:.4f}s = "
              f"{n_tok / dt:.3f} tok/s; decode {tpot:.4f} ms/step (median "
              f"inter-token gap); {sched.stats.steps} decode steps, "
              f"{sched.stats.prefills} prefills; launches {launches[label]}")
        runs[label]["decode_profile"] = profile_decode(eng, label)

    ref = runs["fake-quant"]["results"]
    if sorted(ref) != list(range(len(prompts))):
        raise AssertionError(f"missing requests: {sorted(ref)}")
    for rid, toks in ref.items():
        if len(toks) != NEW_TOKENS or not ((toks >= 0)
                                           & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"rid {rid}: bad stream {toks}")
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
        raise AssertionError(f"main path did not run through the kernels: "
                             f"{launches}")
    main_launches = {"pack_sign": lv["pack_sign"],
                     "xnor_mismatch": lv["xnor_mismatch"],
                     "xnor_dot_mxu": lm_["xnor_dot_mxu"]}
    summary = {k: {kk: vv for kk, vv in v.items() if kk != "results"}
               for k, v in runs.items()}
    return main_launches, summary


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

    err = parity(dev)
    totals, rows = timing(dev, popc_per_s)
    launches, serve_summary = serving(dev)

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
        "kernel_totals_decode_layer": totals, "serving": serve_summary,
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
