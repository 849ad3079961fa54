#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written Hopper kernels from the sources in this
checkout, holds each against its plain PyTorch version, times them, trains
full-width granite-3-2b for a few steps and serves the trained model packed,
and serves granite-3-2b at full width through the continuous-batching
scheduler on those kernels: packed 1-bit and packed DoReFa w4a4 on the
contiguous cache, and packed 1-bit on the paged cache with chunked prefill,
shared prefixes and the flash-decode kernel at every KV tier, and again
with speculative decoding behind a w1a1 draft; then serves the MoE
deepseek-moe-16b at full width, packed 1-bit and packed DoReFa
w4a4, on the expert-batched kernels; then the dense deepseek-7b and
qwen2-72b at full width and full depth, qwen2-72b built one layer at a
time and also on an 8,192-token prompt; last, the paper's binary LeNet and
ResNet-18 at full width, their convs through im2col on the same kernels.

    python3 chip_smoke.py            # needs one CUDA GPU (sm_90a) and nvcc

Phases (any failure exits non-zero before the result line):

1. environment: the card's name and power limit, torch / CUDA versions,
   the kernel build (time and the compiler's register report);
2. kernel parity against the plain versions: exact int32 at the main
   path's GEMM shapes (decode batch and prefill rows) and ragged ones for
   sign-pack (K1), xnor-popcount (K2), int8-unpack (K3), quantize-plane-pack
   (K4) with rounding ties and range edges (and at the MoE prologue's 24 /
   576 rows, K 10944, its chunk edges and whole rows of code ties, each
   called twice, bit for bit), plane AND-popcount (K5) and
   code-lane ``mma`` (K6), and K5 == K6 at plane counts (2,2), (4,4), (8,8)
   and (8,4); flash-decode (K11) within 2e-5 on rows that see a key, over
   fp32 / bf16 / int8 / 1-bit pools, paged and contiguous, C 1/4/256, G 1/4,
   Dh 64/128, softcap and window on and off, ragged slots, a -1 table entry
   and an unmapped slot (exact zeros), and at the speculative verify's
   windows (C 2 / 3 / 5, G 4, Dh 64, every tier, both layouts) after a
   junk window was truncated and the verify window rewritten through the
   caches' own ``truncate`` / ``fill_window``; the expert-batched xnor-popcount
   (K7) and int8-unpack (K8) GEMMs exactly at E 1/3/64, 1/24/77 bucket
   rows, N 1408/2048/33 and Kw 44/64/1/5; K2/K3 and (at E 2) K7/K8 also
   over K3's tile edges, M 1-576 x N 17-2047 x Kw 1-257 (``TILE_CASES``),
   with K3 == 32*Kw - 2*K2 and K8 == 32*Kw - 2*K7 at every case; K2/K7
   once more at each tile and split plan of their decode / prefill tiles,
   on operands at a 4-byte offset, on all-zero / all-ones words, and twice
   (bit for bit); and
   ``quant_gemm_grouped`` on the card == on the CPU (one stack and up +
   gate, full and tight capacity, the route-first prologue); the
   expert-batched plane popcount (K9) and code-lane ``mma`` (K10) GEMMs
   at the same grid times (ka, kb) in {(4, 4), (8, 8), (8, 4)}, exactly
   and K9 == K10; K5 == K6 and (at E 2) K9 == K10 also over the tile edges
   (``TILE_CASES``, one plane pair per shape in turn) and on rows that are
   zero in every plane, which K5 / K6 / K9 / K10 skip (bucket tails and
   empty experts of seeded routings, rows zero in some planes or one Kw
   slice only), where S must be 0; and w4a4
   ``quant_gemm_grouped`` on the card == on the CPU (plane buckets, code
   sums and the dequantized output exactly);
3. timing: each kernel, its plain version and one PyTorch yardstick call
   (bf16 ``torch.matmul`` of the ±1 operands for K2/K3, of the dequantized
   DoReFa operands for K5/K6; ``scaled_dot_product_attention`` on the
   gathered dense K/V for K11; none for K1/K4) at the main-path shapes,
   w4a4 and w8a8 for K4-K6, K11 at decode, at the verify windows C 3 and
   5, and a 256-token prefill window
   per pool tier, with the least time the card could take (``bound_ms``:
   for a GEMM, that of its function, the integer dot of the codes, on the
   int8 tensor cores, whichever kernel computes it; K2/K5's popcount
   ceiling is printed beside it, and K2/K7's carry-save ceiling and tile
   plan; K2, K1 and K4 summed per granite layer at decode and at prefill;
   beside K1 and K4 the graph-node floor, the time of a one-element
   ``zero_`` in the same CUDA-graph harness, and both once more at the MoE
   cell's prologue shapes (24 / 576 rows at K 2048 / 1408, 4 rows at
   K 10944); for K11 the
   admitted rows' bytes or its
   fp32 operations); K7 / K8 (1 bit) and K9 / K10 (w4a4) at
   deepseek-moe-16b's expert GEMMs (64 experts; 24 bucket rows at decode,
   576 at the mix's largest prefill) beside a bf16 ``torch.bmm`` yardstick,
   their bound and (K7, K9) their popcount ceiling, and K9 / K10 once more
   at decode on the buckets of a seeded top-6 routing of 4 tokens (the
   experts touched and their planes' bytes printed beside it); K1-K3 at
   qwen2-72b's seven GEMMs at decode (M 4, N and K up to 29,568) and
   summed per layer; K11 at Dh 128 with fp32 pools at qwen2-72b's heads
   (8 kv-heads, G 8) and deepseek-7b's (32, G 1), at decode and a C 256
   window;
4. training: one step of granite-3-2b smoke (binary, fp32, remat) on the
   card and on the CPU from the same numpy init and batch, whose loss, grad
   norm, moments and new params must agree (``TRAIN_TOL``); then
   granite-3-2b at full width, all 40 layers, params from a seeded
   ``torch.Generator``: one step under ``QuantPolicy.binary()`` reported
   (without alpha the gradient overflows fp32 at this depth), then
   ``TRAIN_STEPS`` AdamW steps (lr 5e-3, warmup 2) of 16 x 256 synthetic
   tokens under ``QuantPolicy.binary(scale=True)`` (XNOR-Net alpha), fp32
   master and compute, every block rematerialised, each step's loss, grad
   norm, bit-flip rate and time printed, then the median step time after
   the first (the last step runs under ``torch.profiler`` and is left out
   of it), tokens/s, the peak memory and the profiled step's device time by
   kernel; every loss must be finite, step 1
   must flip signs and the master must change.  The moments are freed, the
   trained master converted, and the granite mix below served packed
   ``vpu`` (K1 + K2), packed ``mxu`` (K1 + K3) and fake-quant, whose greedy
   streams must be identical (§2.2.2 on a trained model) with K1, K2 and K3
   launched; the ``export_packed`` file, loaded by ``load_packed``, must
   serve the same ``vpu`` streams;
5. serving: granite-3-2b at full width (d_model 2048, 32/8 heads, d_ff 8192,
   vocab 49155 padded to 49408), all 40 layers, params from a seeded
   ``torch.Generator`` on the card, each run with its kernel counts set to
   0 just before it and read just after:
   - 8 requests of mixed prompt length on 4 slots of a 256-row contiguous
     cache, 1-bit (``QuantPolicy.binary()``): packed ``vpu``, packed
     ``mxu`` and fake-quant; the greedy streams must be identical (paper
     §2.2.2);
   - the paged cell, 1-bit packed ``vpu``: 8 requests of a common 512-token
     prefix plus a 64-448-token tail on 4 slots of a 2,048-row cache,
     served contiguous-gather, paged-gather, paged-fused at fp / int8 /
     1-bit KV and contiguous-fused (block 16, prefill chunk 256, shared
     prefixes); the allocator must end empty, prefilled + shared tokens
     must be the prompt tokens with some shared, K11 must launch layers x
     (decode steps + prefill windows) times on the fused runs and never on
     the gather runs, and layer 0's fused attention must stay within the
     rounding bound of the gather oracle at every tier;
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
   - the MoE cell: deepseek-moe-16b at full width (64 routed experts of
     1408, top-6, 2 shared, layer 0 dense), 1-bit, the same request mix:
     all 28 layers packed ``vpu`` and ``mxu`` (the model built layer by
     layer, never whole in fp32), whose streams must be identical; at
     depth 4, packed ``vpu``, ``mxu``, fake-quant and ``vpu`` again, all
     identical (one slot at a time reported beside them); K7 / K8 must
     launch 3 x MoE layers x (decode steps + prefills) times on the
     ``vpu`` / ``mxu`` runs and never elsewhere;
   - the MoE w4a4 cell: the same model and mix under
     ``QuantPolicy.quantized(4)``, all 28 layers (7.5 GB of expert planes)
     packed ``vpu`` (-> vpu-k4) and ``mxu`` (-> mxu-k4), whose streams must
     be identical; at depth 4 ``vpu``, ``mxu`` (identical) and fake-quant
     (agreement reported, not gated); layer 1's up / gate / down grouped
     GEMMs within ``rtol=1e-4, atol=2e-4`` of fake-quant's ``ragged_dot``;
     K9 / K10 must launch 3 x MoE layers x (decode steps + prefills) times
     on the ``vpu`` / ``mxu`` runs and never elsewhere, K4 on every packed
     run;
5b. speculative: the same granite-3-2b at full width cut to its first
   ``SPEC_DEPTH`` layers (the script's time limit), with a draft cut from
   its float params (the first ``SPEC_DRAFT_LAYERS`` layers, packed w1a1):
   contiguous 1-bit ``vpu`` / ``mxu`` and w4a4 ``mxu`` at spec_len 2 on
   the granite mix, the paged cell's mix fused at fp and int8 KV at
   spec_len 4, and the target as its own draft at spec_len 3; every stream
   must equal the target-only stream of the cut target (served first, its
   ``vpu`` and ``mxu`` streams identical, each run under the launch gate
   of phase 5c), the self-draft must
   accept every proposal in fewer rounds than target-only decode steps,
   the prologue and GEMM kernels must launch 7 times per packed layer per
   forward call of target and draft (K11 once per target layer per prefill
   window and verify position), and the verify window's logits must equal
   the decode steps' bit for bit at full width; tokens/s, rounds,
   acceptance and a profile of one round are reported;
5c. dense: the dense llama / qwen family at full width, float32
   compute, seeded weights, each run with its kernel counts set to 0 just
   before it and read just after:
   - deepseek-7b (d_model 4096, 32 heads of 128, MHA, d_ff 11008, vocab
     102400, untied head), all 30 layers, built whole in fp32 (27.6 GB):
     the granite mix 1-bit packed ``vpu``, ``mxu`` and fake-quant, streams
     identical; the paged cell's mix contiguous gather, paged gather
     (streams == contiguous) and paged fused at fp KV (K11 at G 1, layer 0
     within the gather oracle's bound); w4a4 ``vpu-k4`` == ``mxu-k4``;
   - qwen2-72b (d_model 8192, 64 heads over 8 kv-heads of 128, QKV bias,
     rope_theta 1e6, d_ff 29568, vocab 152064), first ``_sdpa_chunked``
     against ``_sdpa`` at its layer-0 shapes and 4,096 positions (both
     within ``ATTN_TOL`` of float64); then all 80 layers built by
     ``lm.init_packed`` (build peak under the packed bytes plus two fp32
     layers): the granite mix ``vpu`` == ``mxu``; the paged cell's mix
     paged gather and paged fused at fp KV (K11 at G 8, layer 0 within the
     oracle's bound); one 8,192-token prompt on a 8,448-row cache, its
     prefill through ``_sdpa_chunked``, ``vpu`` == ``mxu``; and at depth 4
     (about 24 GB of fp32 weights) ``vpu`` == ``mxu`` == fake-quant on the
     mix and on the long prompt;
   every run's prologue and GEMM launch 7 x layers x (decode steps +
   prefill calls) times (K11 layers x (decode steps + windows) on fused
   runs) and nothing else; the decode steps of both models' ``vpu`` runs
   and qwen2-72b's paged fused run are profiled;
6. cnn: the paper's binary CNNs (``models/cnn.py``, fp32), their convs
   as im2col + the packed GEMMs on K1-K6:
   - smoke LeNet-MNIST and ResNet-18-CIFAR from one seeded init on the CPU
     and on the card, fp / 1-bit / w4a4: logits card vs CPU within
     ``CNN_CARD_ATOL`` while no binarized activation differs (one that does
     must lie within ``CNN_TIE_EPS`` of its boundary in the first layer
     where any differs); on the card packed ``vpu`` == ``mxu`` (==
     fake-quant at 1 bit) at conv K 72 / 144 / 200;
   - full width, seeded weights: LeNet (64 / 64 / 1000, 28 x 28, batch
     256) and ResNet-18 (widths 64-512, 32 x 32, batch 128); 1-bit packed
     ``vpu`` == ``mxu`` == fake-quant logits bit for bit; w4a4 ``vpu-k4``
     == ``mxu-k4`` and every binarized layer, fed fake-quant's input,
     within ``rtol=1e-4, atol=2e-4`` of fake-quant (the whole model
     reported); each packed forward launches its prologue (K1 / K4) and
     GEMM (K2 / K3 / K5 / K6) once per binarized layer, fake-quant none;
     the median forward ms of every variant and a profile of each packed
     variant (device time of K1-K6 and the largest kernels per forward,
     with the K1-K6 launches the trace holds);
   - ``CNN_TRAIN_STEPS`` steps of full-width binary LeNet with the
     ``binary_mnist`` twin's step, then packed ``vpu`` == ``mxu`` ==
     fake-quant on the trained weights;
7. the ``kernels`` JSON line, then the result line.

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
# popcounts per word pair of K2 / K7's carry-save fold (popc8: 8 words in 4)
CSA_POPC_PER_WORD = 0.5

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
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/attn_decode.py:259"),
    "xnor_mismatch_batched": ("src/repro_torch/csrc/xnor_mismatch.cu",
                              "src/repro/kernels/xnor_gemm.py:250"),
    "xnor_dot_mxu_batched": ("src/repro_torch/csrc/xnor_dot_mxu.cu",
                             "src/repro/kernels/xnor_gemm.py:267"),
    "kbit_plane_gemm_batched": ("src/repro_torch/csrc/kbit_plane_gemm.cu",
                                "src/repro/kernels/kbit_gemm.py:197"),
    "kbit_mxu_gemm_batched": ("src/repro_torch/csrc/kbit_mxu_gemm.cu",
                              "src/repro/kernels/kbit_mxu.py:261"),
}
ONE_BIT = ("pack_sign", "xnor_mismatch", "xnor_dot_mxu")
MOE_KERNELS = ("xnor_mismatch_batched", "xnor_dot_mxu_batched")  # K7, K8
# K9, K10
MOE_KBIT_KERNELS = ("kbit_plane_gemm_batched", "kbit_mxu_gemm_batched")
MOE_BATCHED = {1: dict(zip(("vpu", "mxu"), MOE_KERNELS)),
               4: dict(zip(("vpu", "mxu"), MOE_KBIT_KERNELS))}
MOE_PLANE_PAIRS = ((4, 4), (8, 8), (8, 4))  # (ka, kb) of the K9/K10 parity
K_BIT = ("quant_pack_planes", "kbit_plane_gemm", "kbit_mxu_gemm")

FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
ATTN_TOL = 2e-5  # the JAX package's fused-attention test tolerance
ATTN_TIERS = ("fp32", "bf16", 8, 1)  # fp pools by dtype, then kv_bits
# the paged serving cell: chat / RAG traffic behind a shared system prompt
PAGED_CACHE_LEN = 2048
PAGED_BLOCK = 16
PAGED_CHUNK = 256
PREFIX_LEN = 512
TAIL_LENS = (64, 448)  # unique tail per request, uniform from the seed
PAGED_REQUESTS = 8
PAGED_NEW_TOKENS = 32
# speculative decoding: granite cut to 16 of its 40 layers (the script's
# time limit) and a w1a1 draft of the cut's leading quarter (4 layers); the
# verify windows K11 is timed at, spec_len + 1 for spec_len 2 (C*G 12, the
# decode tile) and 4 (C*G 20, the window tile)
SPEC_DEPTH = 16
SPEC_DRAFT_LAYERS = 4
SPEC_VERIFY_C = (3, 5)
# the MoE cell: deepseek-moe-16b's expert GEMMs, (name, N, K) per expert
TRAIN_BATCH, TRAIN_SEQ = 16, 256  # the full-width train step's tokens
TRAIN_STEPS = 8
TRAIN_OPT = dict(lr=5e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
# one smoke step on the card against the CPU (tests/test_torch_train.py
# derives these gates against JAX): loss, grad norm, moments within this
# share of each leaf's largest |m| / |v|, new params within 1e-3 * lr where
# |m| is above 1e-3 of its leaf's largest and within 2 * lr everywhere
TRAIN_TOL = dict(loss_rtol=2e-6, gnorm_rtol=1e-5, moment_rel=2e-5)

# the CNN phase: the paper's binary LeNet-MNIST and ResNet-18-CIFAR
# (Table 1), fp32 compute
CNN_ARCHS = ("lenet-mnist", "resnet18-cifar10")
CNN_WIDTHS = {"lenet-mnist": (64, 64, 1000, 28, 1),
              "resnet18-cifar10": ((64, 128, 256, 512), 32, 3)}
CNN_BATCH = {"lenet-mnist": 256, "resnet18-cifar10": 128}
CNN_SMOKE_BATCH = 16
# smoke logits, card against CPU, while no binarized activation differs
# (tests/test_torch_cnn.py measures JAX against the port on the CPU at up to
# 1.6e-6); a differing one must lie within CNN_TIE_EPS of its sign or code
# boundary in the first layer where any differs
CNN_CARD_ATOL = 1e-4
CNN_TIE_EPS = 1e-5
CNN_TRAIN_STEPS = 20
CNN_TIMING_REPS = 10
CNN_PROFILE_REPS = 5  # forwards in one profiler window

# the dense phase: deepseek-7b and qwen2-72b at full width; qwen2-72b's
# long prompt (its prefill takes _sdpa_chunked) on one slot, its fake-quant
# oracle depth, and the length _sdpa_chunked is held against _sdpa at
LONG_PROMPT = 8192
LONG_CACHE_LEN = LONG_PROMPT + CACHE_LEN
DENSE_CUT_DEPTH = 4
CHUNKED_SEQ = 4096
# qwen2-72b's packed GEMMs, (name, N, K), in the order a layer runs them
QWEN_LAYER_GEMMS = (("q", 8192, 8192), ("k", 1024, 8192), ("v", 1024, 8192),
                    ("o", 8192, 8192), ("up", 29568, 8192),
                    ("gate", 29568, 8192), ("down", 8192, 29568))
# deepseek-7b's packed GEMMs, (name, N, K)
DEEPSEEK_LAYER_GEMMS = (("q", 4096, 4096), ("k", 4096, 4096),
                        ("v", 4096, 4096), ("o", 4096, 4096),
                        ("up", 11008, 4096), ("gate", 11008, 4096),
                        ("down", 4096, 11008))
# the dense models' distinct (N, K), held against the plain versions at the
# rows their serving runs give the GEMMs: decode (1, 4) and a prefill
# admission group (256); qwen2-72b's also at its long prompt's rows
DENSE_SHAPES = tuple(sorted({(n, k) for _, n, k in QWEN_LAYER_GEMMS
                             + DEEPSEEK_LAYER_GEMMS}))
DENSE_MS = (1, DECODE_M, PREFILL_M)
QWEN_SHAPES = tuple(sorted({(n, k) for _, n, k in QWEN_LAYER_GEMMS}))

MOE_ARCH = "deepseek-moe-16b"
MOE_GEMMS = (("up", 1408, 2048), ("gate", 1408, 2048), ("down", 2048, 1408))
MOE_EXPERTS, MOE_TOP_K = 64, 6
MOE_DECODE_EC = DECODE_M * MOE_TOP_K  # 24 bucket rows: capacity T*k at decode
MOE_PREFILL_EC = 2 * 48 * MOE_TOP_K  # the mix's 96-token prefill run x top-6
MOE_CUT_DEPTH = 4  # the dense layer 0 + 3 MoE layers, for the fake-quant oracle
# K3 / K8 tile boundaries (as tests/test_torch_gpu.py): M on both sides of
# the decode tile's 32 rows and K8's 24 / 576 buckets, N off the 16- and
# 128-row tiles, Kw ragged against the 16-word chunk and the split-K runs
TILE_CASES = [(m, n, kw) for m in (1, 4, 8, 9, 24, 32, 33, 64, 256, 576)
              for n in (17, 512, 1408, 2047) for kw in (1, 5, 63, 65, 257)]
# K5 / K6 / K9 / K10 zero-row cases (as tests/test_torch_gpu.py): rows whose
# planes are all zero, which the kernels skip, at decode- and prefill-tile
# shapes
ZERO_ROWS = ("front", "planes", "slice", "all")
ZERO_SHAPES = ((4, 2048, 64), (24, 1408, 63), (32, 512, 257), (33, 65, 9),
               (256, 1408, 65), (576, 17, 5))
EDGE_PLANE_PAIRS = PLANE_PAIRS + ((3, 5),)  # (ka, kb) cycled over TILE_CASES
# the activation prologues (K1, K4) at the MoE cell's shapes: the 24 / 576
# expert-sorted rows at K 2048 (up / gate) and 1408 (down), and
# deepseek-moe-16b's dense layer-0 `down` input (d_ff 10944) at decode
PROLOGUE_SHAPES = ((MOE_DECODE_EC, 2048), (MOE_DECODE_EC, 1408),
                   (MOE_PREFILL_EC, 2048), (MOE_PREFILL_EC, 1408),
                   (DECODE_M, 10944))
# K4 parity beyond granite's shapes (as tests/test_torch_gpu.py): the
# prologue shapes above, one row, Kw 37 (a row over 5 warps of 8 words),
# Kw 529 (two chunks of 32 warps of 16 words) and 576 rows at K 10944
K4_CASES = PROLOGUE_SHAPES + ((1, 10944), (DECODE_M, 37 * 32 - 5),
                              (2, 529 * 32 - 7), (MOE_PREFILL_EC, 10944))
K4_TIE_SHAPES = ((DECODE_M, 2048), (MOE_DECODE_EC, 1408),
                 (MOE_PREFILL_EC, 2048), (DECODE_M, 10944))
# K1 parity beyond granite's shapes (as tests/test_torch_gpu.py): the
# prologue shapes, the dense `down` input at one and 576 rows, many rows of
# one word, and K one float and one word either side of each edge of the
# plan (a warp's 256 floats at decode and 512 at prefill, 4 warps a block)
# and its multiples, at decode, just past it and at prefill rows; K % 4 != 0
# is read by 4-byte loads
K1_EDGE_K = tuple(e + d for e in (256, 512, 1024, 2048, 4096, 8192, 16384)
                  for d in (-32, -1, 1, 32))
K1_CASES = (PROLOGUE_SHAPES
            + ((1, 10944), (MOE_PREFILL_EC, 10944), (4096, 33))
            + tuple((m, k) for m in (DECODE_M, 33, PREFILL_M)
                    for k in K1_EDGE_K))


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


def sign_edge_rows(m: int, k: int, dev) -> torch.Tensor:
    """Rows cycling through the sign's edge values (±0, NaN of either sign,
    ±inf, ±denormals, ±1) with a period of 13, odd to every lane's stride,
    so every lane and every bit of a word meets each of them."""
    edge = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                         -float("inf"), 1e-45, -1e-45, 1e-39, -1e-39, 1.0,
                         -1.0, 3.0], device=dev)
    neg_nan = torch.tensor([-(1 << 22)], dtype=torch.int32,
                           device=dev).view(torch.float32)  # 0xffc00000
    edge = torch.cat([edge, neg_nan])
    idx = (torch.arange(m * k, device=dev).reshape(m, k)
           + 5 * torch.arange(m, device=dev).reshape(m, 1)) % edge.numel()
    return edge[idx]


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` one float into its storage: contiguous, not 16-byte
    aligned."""
    buf = torch.empty(x.numel() + 1, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


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
    # K3's tile boundaries, K ragged in the last word
    cases += [(m, n, 32 * kw - (m + n + kw) % 32) for m, n, kw in TILE_CASES]
    # the dense models' GEMMs: N / K up to 29,568 (Kw 924)
    cases += [(m, n, k) for n, k in DENSE_SHAPES for m in DENSE_MS]
    err = {name: 0.0 for name in ONE_BIT}
    for m, n, k in cases:
        x = edge_floats((m, k), gen, dev)
        w = edge_floats((n, k), gen, dev)
        xp, wp = pack_bits.pack_sign(x), pack_bits.pack_sign(w)
        mism = xnor_gemm.xnor_mismatch(xp, wp)
        dot = xnor_gemm.xnor_dot_mxu(xp, wp)
        pairs = {
            "pack_sign": [(xp, pack_bits.pack_sign_plain(x)),
                          (wp, pack_bits.pack_sign_plain(w))],
            "xnor_mismatch": [(mism, xnor_gemm.xnor_mismatch_plain(xp, wp))],
            "xnor_dot_mxu": [(dot, xnor_gemm.xnor_dot_mxu_plain(xp, wp)),
                             (dot, 32 * xp.shape[1] - 2 * mism)],
        }
        torch.cuda.synchronize()
        check_exact(pairs, err, f"M={m} N={n} K={k}")
    # K1 at its plan's edges: random floats with the edge values mixed in,
    # rows of edge values in every lane, and the first of them one float into
    # its storage (4-byte loads); each called twice, bit for bit
    n_k1 = 0
    for m, k in K1_CASES:
        x = edge_floats((m, k), gen, dev)
        for kind, xs in (("floats", x), ("edge rows", sign_edge_rows(m, k, dev)),
                         ("misaligned", misaligned(x))):
            got = pack_bits.pack_sign(xs)
            again = pack_bits.pack_sign(xs)
            torch.cuda.synchronize()
            check_exact({"pack_sign": [(got, pack_bits.pack_sign_plain(xs)),
                                       (again, got)]}, err,
                        f"M={m} K={k} {kind}")
            n_k1 += 1
    long_rows = parity_long_prefill(dev, gen, err)
    print(f"parity: {len(cases)} shapes ({len(DENSE_SHAPES) * len(DENSE_MS)} "
          f"of them qwen2-72b's and deepseek-7b's GEMMs at M {DENSE_MS}), "
          f"K1-K3 equal their plain versions exactly (int32), and K3 == "
          f"32*Kw - 2*K2; K1 also at {n_k1} "
          f"cases ({len(K1_CASES)} shapes: the MoE prologue's, K 10944, "
          f"4096 rows of one word and K either side of the plan's chunk "
          f"edges; floats, rows of edge values in every lane and a "
          f"misaligned view), each called twice, bit for bit; at qwen2-72b's "
          f"{LONG_PROMPT}-row prefill ({len(QWEN_SHAPES)} shapes) K1 whole, "
          f"K3 == 32*Kw - 2*K2 over the whole output and both against their "
          f"plain versions on {long_rows} rows (the first row block and the "
          f"last ones)")
    return err


def parity_long_prefill(dev, gen, err: dict) -> int:
    """K1-K3 at qwen2-72b's ``LONG_PROMPT``-row prefill GEMMs (K2's
    prefill row blocks and K3's split-K plan at M 8,192, Kw up to 924):
    K1 exactly against its plain version over the whole input, K3 == 32*Kw
    - 2*K2 exactly over the whole output, and K2 / K3 exactly against their
    plain versions on the first 64 rows and the last 160 (which hold the
    last row block of either tile).  Returns the rows held against the
    plain versions."""
    from repro_torch.kernels import pack_bits, xnor_gemm

    m = LONG_PROMPT
    rows = torch.cat([torch.arange(64), torch.arange(m - 160, m)]).to(dev)
    for n, k in QWEN_SHAPES:
        x = edge_floats((m, k), gen, dev)
        w = edge_floats((n, k), gen, dev)
        xp, wp = pack_bits.pack_sign(x), pack_bits.pack_sign(w)
        mism = xnor_gemm.xnor_mismatch(xp, wp)
        dot = xnor_gemm.xnor_dot_mxu(xp, wp)
        torch.cuda.synchronize()
        check_exact({"pack_sign": [(xp, pack_bits.pack_sign_plain(x)),
                                   (wp, pack_bits.pack_sign_plain(w))]},
                    err, f"M={m} N={n} K={k}")
        del x, w
        check_exact({"xnor_dot_mxu": [(dot, 32 * xp.shape[1] - 2 * mism)]},
                    err, f"M={m} N={n} K={k}, whole output")
        sub = xp[rows]
        check_exact({"xnor_mismatch": [(mism[rows], xnor_gemm.xnor_mismatch_plain(
                         sub, wp))],
                     "xnor_dot_mxu": [(dot[rows], xnor_gemm.xnor_dot_mxu_plain(
                         sub, wp))]}, err, f"M={m} N={n} K={k}, {len(rows)} rows")
        del xp, wp, mism, dot, sub
        torch.cuda.empty_cache()
    return len(rows)


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


def tie_rows(m: int, k: int, a_bits: int, dev) -> torch.Tensor:
    """Rows whose values sit on the code ties (j + 0.5)/Na and one float
    either side of them, cycling over j: round-half-to-even decides every
    code of the ties."""
    na = (1 << a_bits) - 1
    ties = torch.tensor([(j + 0.5) / na for j in range(na)], device=dev)
    vals = torch.stack([ties, torch.nextafter(ties, torch.full_like(ties, 2)),
                        torch.nextafter(ties, torch.full_like(ties, -1))])
    reps = -(-m * k // vals.numel())
    return vals.reshape(-1).repeat(reps)[: m * k].reshape(m, k)


def weight_planes(n: int, k: int, w_bits: int, gen, dev) -> torch.Tensor:
    """A (w_bits, N, Kw) plane stack of DoReFa codes of normal weights, as
    the converter packs them."""
    from repro_torch.core import bitpack, quant

    w = torch.randn((n, k), generator=gen, device=dev)
    return bitpack.pack_planes(quant.weight_codes(w, w_bits), w_bits)


def zero_rows(a, zeros):
    """Zero rows of a (..., ka, M, Kw) activation plane stack in place and
    return the (..., M) mask of rows zero in every plane and word: "front"
    keeps the first third of the rows (a bucket's rows packed at the front,
    zeros behind), "planes" zeroes every other row in its low planes only,
    "slice" every third row in the upper half of its words only, "all"
    every row."""
    m, kw = a.shape[-2:]
    if zeros == "front":
        a[..., (m + 2) // 3:, :] = 0
    elif zeros == "planes":
        a[..., : (a.shape[-3] + 1) // 2, ::2, :] = 0
    elif zeros == "slice":
        a[..., ::3, kw // 2:] = 0
    elif zeros == "all":
        a.zero_()
    return (a == 0).all(dim=-1).all(dim=-2)


def check_zero_rows(name: str, s, zero, where: str) -> None:
    """S must be exactly 0 on the rows that are zero in every plane."""
    if s[zero].any():
        raise AssertionError(f"{name} at {where}: nonzero S on a zero row")


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
    # the MoE prologue's rows, long rows, chunk edges, rows of code ties, the
    # dense models' GEMM inputs at w4a4, and a second call that must repeat
    # the first bit for bit
    k4_new = [(m, k, a_bits, "acts") for m, k in K4_CASES
              for a_bits in (2, 3, 4, 8)]
    k4_new += [(m, k, 4, "acts") for k in sorted({k for _, k in DENSE_SHAPES})
               for m in DENSE_MS]
    k4_new += [(m, k, a_bits, "ties") for m, k in K4_TIE_SHAPES
               for a_bits in (2, 3, 4, 8)]
    for m, k, a_bits, kind in k4_new:
        x = (dorefa_acts((m, k), gen, dev, a_bits) if kind == "acts"
             else tie_rows(m, k, a_bits, dev))
        got = pack_bits.quant_pack_planes(x, a_bits)
        again = pack_bits.quant_pack_planes(x, a_bits)
        want = pack_bits.quant_pack_planes_plain(x, a_bits)
        torch.cuda.synchronize()
        check_exact({"quant_pack_planes": list(zip(got, want))
                     + list(zip(again, got))}, err,
                    f"M={m} K={k} a_bits={a_bits} {kind}")
        n_k4 += 1
    # granite's GEMMs at the decode batch and the prefill rows (the decode
    # tiles' split-K runs and row groups) at every plane pair
    cases = [(m, n, k, EDGE_PLANE_PAIRS if m > 1 else PLANE_PAIRS)
             for _, n, k in LAYER_GEMMS for m in (1, DECODE_M, PREFILL_M)]
    cases += [(m, n, k, PLANE_PAIRS) for m in (1, 3, 128)
              for n, k in ((2047, 2049), (513, 8191), (65, 33))]
    # the dense models' GEMMs at w4a4 (deepseek-7b serves it); past the
    # decode rows of a GEMM larger than granite's, K5's plain version (ka*kb
    # int64 popcount passes) would take seconds a call, so K5 is held there
    # against K6's plain version, which computes the same integer in float64
    cases += [(m, n, k, ((4, 4),)) for n, k in DENSE_SHAPES for m in DENSE_MS]
    n_gemm = sum(len(pairs) for *_, pairs in cases)
    for m, n, k, pairs in cases:
        for ka, kb in pairs:
            ap, _ = pack_bits.quant_pack_planes(
                dorefa_acts((m, k), gen, dev, ka), ka)
            wp = weight_planes(n, k, kb, gen, dev)
            s5 = kbit_gemm.kbit_plane_gemm(ap, wp)
            s6 = kbit_mxu.kbit_mxu_gemm(ap, wp)
            want6 = kbit_mxu.kbit_mxu_gemm_plain(ap, wp)
            want = (kbit_gemm.kbit_plane_gemm_plain(ap, wp)
                    if m <= DECODE_M or n * k <= 8192 * 2048 else want6)
            torch.cuda.synchronize()
            check_exact({"kbit_plane_gemm": [(s5, want)],
                         "kbit_mxu_gemm": [(s6, want6), (s6, s5)]}, err,
                        f"M={m} N={n} K={k} ka={ka} kb={kb}")
    # the tiles' edges, one plane pair per shape in turn, and zero rows at
    # every plane pair (random words, which reach every bit)
    edges = [(m, n, kw, None, EDGE_PLANE_PAIRS[i % len(EDGE_PLANE_PAIRS)])
             for i, (m, n, kw) in enumerate(TILE_CASES)]
    edges += [(m, n, kw, z, pair) for z in ZERO_ROWS
              for m, n, kw in ZERO_SHAPES for pair in PLANE_PAIRS]
    for m, n, kw, zeros, (ka, kb) in edges:
        ap = expert_words((ka, m, kw), 32 * kw, gen, dev)
        wp = expert_words((kb, n, kw), 32 * kw, gen, dev)
        zero = zero_rows(ap, zeros)
        s5 = kbit_gemm.kbit_plane_gemm(ap, wp)
        s6 = kbit_mxu.kbit_mxu_gemm(ap, wp)
        want = kbit_gemm.kbit_plane_gemm_plain(ap, wp)
        torch.cuda.synchronize()
        where = f"M={m} N={n} Kw={kw} ka={ka} kb={kb} zero rows {zeros}"
        check_exact({"kbit_plane_gemm": [(s5, want)],
                     "kbit_mxu_gemm": [(s6, kbit_mxu.kbit_mxu_gemm_plain(
                         ap, wp)), (s6, s5)]}, err, where)
        check_zero_rows("kbit_plane_gemm", s5, zero, where)
        check_zero_rows("kbit_mxu_gemm", s6, zero, where)
    print(f"parity: K4 at {n_k4} (M, K, a_bits) cases ({len(k4_new)} of "
          f"them the MoE prologue's rows, K 10944, chunk edges and rows of "
          f"code ties, each called twice, bit for bit), K5/K6 at "
          f"{n_gemm} (shape, plane pair) cases ({len(cases)} shapes, "
          f"granite's at M {DECODE_M} and {PREFILL_M} over "
          f"{EDGE_PLANE_PAIRS}, qwen2-72b's and deepseek-7b's at M "
          f"{DENSE_MS} at (4, 4); K5 against K6's plain version above "
          f"M {DECODE_M} there), "
          f"{len(TILE_CASES)} tile-edge shapes (ka, kb cycling over "
          f"{EDGE_PLANE_PAIRS}) and {len(edges) - len(TILE_CASES)} zero-row "
          f"cases: equal to their plain versions and K5 == K6, exactly "
          f"(int32); S == 0 on every row zero in all planes")
    return err


def parity_xnor(dev) -> dict[str, float]:
    """K2 / K7 exactly against their plain versions at each tile and plan
    of csrc/xnor_mismatch.cu (as tests/test_torch_gpu.py): M around the
    decode tile's 32 rows with small N (row groups), N off the 16-row warp
    tile, ragged Kw, granite's GEMMs at the rows that give every split
    count, deepseek-moe-16b's expert GEMMs at 24 and 576 bucket rows;
    operands one word into a buffer (4-byte, not 16-byte aligned); words
    all zero or all ones (sums 0 or 32*Kw); and two calls on the same
    inputs, which must give the same bits."""
    from repro_torch.kernels import xnor_gemm

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def words(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def run(a, b):
        if a.dim() == 3:
            return (xnor_gemm.xnor_mismatch_batched(a, b),
                    xnor_gemm.xnor_mismatch_batched_plain(a, b),
                    "xnor_mismatch_batched")
        return (xnor_gemm.xnor_mismatch(a, b),
                xnor_gemm.xnor_mismatch_plain(a, b), "xnor_mismatch")

    edges = [(m, n, kw) for m in (31, 32, 33, 64, 65)
             for n, kw in ((17, 64), (40, 44), (100, 9), (250, 16))]
    cases = [(1, m, n, kw) for m, n, kw in edges]
    cases += [(3, m, n, kw) for m, n, kw in edges]
    cases += [(1, m, n, k // 32) for m in (1, 4, 8, 32, 96, PREFILL_M)
              for _, n, k in LAYER_GEMMS]
    cases += [(MOE_EXPERTS, ec, n, k // 32)
              for ec in (MOE_DECODE_EC, MOE_PREFILL_EC) for _, n, k in MOE_GEMMS]
    err = {"xnor_mismatch": 0.0, "xnor_mismatch_batched": 0.0}
    plans = set()
    for e, m, n, kw in cases:
        lead = () if e == 1 else (e,)
        a, b = words((*lead, m, kw)), words((*lead, n, kw))
        got, want, name = run(a, b)
        again = run(a, b)[0]
        torch.cuda.synchronize()
        check_exact({name: [(got, want)]}, err, f"E={e} M={m} N={n} Kw={kw}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} E={e} M={m} N={n} Kw={kw}: two "
                                 "calls differ")
        p = xnor_gemm.tile_plan(e, m, n, kw, sms)
        plans.add((p["tile"], p.get("splits"), p.get("row_groups", 1) > 1))
    n_unaligned = n_const = 0
    for lead in ((), (2,)):
        for m, n, kw in ((4, 100, 64), (24, 1408, 44), (33, 17, 8),
                         (256, 130, 20)):
            sa, sb = (*lead, m, kw), (*lead, n, kw)
            a = words((math.prod(sa) + 1,))[1:].view(sa)
            b = words((math.prod(sb) + 1,))[1:].view(sb)
            got, want, name = run(a, b)
            torch.cuda.synchronize()
            check_exact({name: [(got, want)]}, err, f"unaligned {sa} x {sb}")
            n_unaligned += 1
        for m, n, kw in ((4, 2048, 256), (24, 40, 44), (256, 130, 63)):
            for fa, fb in ((0, -1), (-1, 0), (-1, -1), (0, 0)):
                a = torch.full((*lead, m, kw), fa, dtype=torch.int32,
                               device=dev)
                b = torch.full((*lead, n, kw), fb, dtype=torch.int32,
                               device=dev)
                got, want, name = run(a, b)
                torch.cuda.synchronize()
                check_exact({name: [(got, want), (got, torch.full_like(
                    got, 32 * kw if fa != fb else 0))]}, err,
                    f"words {fa} x {fb} {(*lead, m, n, kw)}")
                n_const += 1
    splits = sorted({s for t, s, _ in plans if t == "decode"})
    print(f"parity: K2/K7 at {len(cases)} tile-plan cases (decode tile "
          f"splits {splits}, row groups "
          f"{any(g for t, _, g in plans if t == 'decode')}, prefill tile "
          f"{any(t == 'prefill' for t, _, _ in plans)}), {n_unaligned} "
          f"unaligned and {n_const} all-zero / all-ones cases: equal to "
          f"their plain versions exactly (int32), two calls bit for bit")
    return err


def expert_words(shape, k_true: int, gen, dev) -> torch.Tensor:
    """Random int32 words of shape (..., Kw) with the bits past ``k_true``
    zeroed, as packing leaves them."""
    w = torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                      dtype=torch.int64)
    bit = torch.arange(shape[-1] * 32, device=dev).view(shape[-1], 32)
    mask = ((bit < k_true).long() << torch.arange(32, device=dev)).sum(-1)
    return (w & mask).to(torch.int32)


def routed_group_sizes(t: int, gen, dev) -> torch.Tensor:
    """Group sizes of ``t`` tokens' top-6 routing over 64 experts from
    random router probabilities (empty experts included)."""
    probs = torch.rand((t, MOE_EXPERTS), generator=gen, device=dev)
    idx = probs.topk(MOE_TOP_K, dim=-1).indices.reshape(-1)
    return torch.bincount(idx, minlength=MOE_EXPERTS)


def parity_moe(dev) -> dict[str, float]:
    """K7 / K8 against their plain versions, bit for bit, at E in {1, 3,
    64}, bucket rows in {1, 24, 77}, N in {1408, 2048, 33}, Kw in {44, 64,
    1, 5}, and at E 2 over K8's tile edges (``TILE_CASES``; random words,
    tail bits zeroed), with K8 == 32*Kw - 2*K7 at each; then
    ``quant_gemm_grouped`` on the card against the same call on the CPU
    for ``vpu`` and ``mxu``, one stack and the up + gate tuple, full and
    tight capacity: at the decode
    shapes of deepseek-moe-16b (24 rows routed top-6 over 64 experts, up /
    gate K 2048 and down K 1408), and at a small ragged shape whose tight
    capacity takes the route-first prologue."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import dispatch, xnor_gemm

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    err = {name: 0.0 for name in MOE_KERNELS}
    cases = [(e, ec, n, kw) for e in (1, 3, MOE_EXPERTS)
             for ec in (1, MOE_DECODE_EC, 77) for n in (1408, 2048, 33)
             for kw in (44, 64, 1, 5)]
    cases += [(2, ec, n, kw) for ec, n, kw in TILE_CASES]  # K8's tile edges
    for e, ec, n, kw in cases:
        k_true = kw * 32 - int(torch.randint(0, 32, (1,), generator=gen,
                                             device=dev))
        a = expert_words((e, ec, kw), k_true, gen, dev)
        b = expert_words((e, n, kw), k_true, gen, dev)
        mism = xnor_gemm.xnor_mismatch_batched(a, b)
        dot = xnor_gemm.xnor_dot_mxu_batched(a, b)
        pairs = {
            "xnor_mismatch_batched": [(
                mism, xnor_gemm.xnor_mismatch_batched_plain(a, b))],
            "xnor_dot_mxu_batched": [(
                dot, xnor_gemm.xnor_dot_mxu_batched_plain(a, b)),
                (dot, 32 * kw - 2 * mism)]}
        torch.cuda.synchronize()
        check_exact(pairs, err, f"E={e} ec={ec} N={n} Kw={kw}")
    n_cases = len(cases)
    grouped = [  # (label, T, K, N, group sizes, capacities)
        ("decode up/gate", MOE_DECODE_EC, 2048, 1408,
         routed_group_sizes(DECODE_M, gen, dev), (None, 3)),
        ("decode down", MOE_DECODE_EC, 1408, 2048,
         routed_group_sizes(DECODE_M, gen, dev), (None, 3)),
        ("ragged", 48, 300, 70,
         torch.tensor([9, 0, 13, 1, 0, 11, 6, 4], device=dev), (None, 6, 2)),
    ]
    n_grouped = 0
    for label, t, k, n, gs, caps in grouped:
        e = gs.numel()
        x = edge_floats((t, k), gen, dev)
        ws = tuple(bitpack.pack_sign(edge_floats((e, n, k), gen, dev))
                   for _ in range(2))
        for backend in ("vpu", "mxu"):
            cfg = dispatch.GemmConfig(backend=backend)
            for stacks in (ws[0], ws):
                for cap in caps:
                    got = dispatch.quant_gemm_grouped(
                        x, stacks, gs, k_true=k, config=cfg,
                        expert_capacity=cap)
                    cpu = (tuple(w.cpu() for w in stacks)
                           if isinstance(stacks, tuple) else stacks.cpu())
                    want = dispatch.quant_gemm_grouped(
                        x.cpu(), cpu, gs.cpu(), k_true=k, config=cfg,
                        expert_capacity=cap)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    for g_, w_ in zip(got, want):
                        if not torch.equal(g_.cpu(), w_):
                            raise AssertionError(
                                f"quant_gemm_grouped {backend} {label} "
                                f"capacity {cap}: card != CPU")
                    n_grouped += 1
    print(f"parity: K7/K8 at {n_cases} (E, rows, N, Kw) cases equal their "
          f"plain versions exactly (int32), and K8 == 32*Kw - 2*K7; "
          f"quant_gemm_grouped on the card "
          f"== on the CPU in {n_grouped} calls (vpu/mxu x one stack/up+gate "
          f"x full/tight capacity; deepseek-moe-16b decode shapes and a "
          f"route-first case)")
    return err


def expert_planes(e: int, n: int, k: int, w_bits: int, gen, dev):
    """An (E, w_bits, N, Kw) expert plane stack of DoReFa codes of normal
    weights, codes over the whole stack, as the converter packs it."""
    from repro_torch.core import bitpack, quant

    w = torch.randn((e, n, k), generator=gen, device=dev)
    return bitpack.pack_planes(quant.weight_codes(w, w_bits),
                               w_bits).transpose(0, 1).contiguous()


def parity_moe_kbit(dev) -> dict[str, float]:
    """K9 / K10 against their plain versions and each other, bit for bit,
    at E in {1, 3, 64}, bucket rows in {1, 24, 77}, N in {1408, 2048, 33},
    Kw in {44, 64, 1, 5} and (ka, kb) in {(4, 4), (8, 8), (8, 4)} (random
    words, tail bits zeroed); then ``quant_gemm_grouped`` at w4a4 on the
    card against the same call on the CPU for ``vpu`` and ``mxu``, full and
    tight capacity: the plane buckets and code sums exactly, and the
    dequantized output exactly too (one fp32 multiply of an exact integer
    on both), at the decode shapes of deepseek-moe-16b and a small ragged
    shape whose tight capacity takes the route-first prologue."""
    from repro_torch.kernels import dispatch, kbit_gemm, kbit_mxu

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    err = {name: 0.0 for name in MOE_KBIT_KERNELS}
    n_cases = 0
    for e in (1, 3, MOE_EXPERTS):
        for ec in (1, MOE_DECODE_EC, 77):
            for n in (1408, 2048, 33):
                for kw in (44, 64, 1, 5):
                    for ka, kb in MOE_PLANE_PAIRS:
                        k_true = kw * 32 - int(torch.randint(
                            0, 32, (1,), generator=gen, device=dev))
                        a = expert_words((e, ka, ec, kw), k_true, gen, dev)
                        b = expert_words((e, kb, n, kw), k_true, gen, dev)
                        s9 = kbit_gemm.kbit_plane_gemm_batched(a, b)
                        s10 = kbit_mxu.kbit_mxu_gemm_batched(a, b)
                        pairs = {
                            "kbit_plane_gemm_batched": [(
                                s9, kbit_gemm.kbit_plane_gemm_batched_plain(
                                    a, b))],
                            "kbit_mxu_gemm_batched": [
                                (s10, kbit_mxu.kbit_mxu_gemm_batched_plain(
                                    a, b)), (s10, s9)]}
                        torch.cuda.synchronize()
                        check_exact(pairs, err, f"E={e} ec={ec} N={n} Kw={kw}"
                                    f" ka={ka} kb={kb}")
                        n_cases += 1
                        del a, b, s9, s10, pairs
    # the tiles' edges at E 2 (one plane pair per shape in turn); zero rows:
    # buckets packed at the front by a seeded top-6 routing (4 and 96
    # tokens over 64 experts, empty experts included), and rows zero in
    # some planes or one Kw slice only
    edges = [(2, m, n, kw, None, MOE_PLANE_PAIRS[i % len(MOE_PLANE_PAIRS)])
             for i, (m, n, kw) in enumerate(TILE_CASES)]
    edges += [(MOE_EXPERTS, ec, n, kw, "routed", pair)
              for ec in (MOE_DECODE_EC, MOE_PREFILL_EC)
              for n, kw in ((1408, 64), (2048, 44)) for pair in MOE_PLANE_PAIRS]
    edges += [(3, m, n, kw, z, pair) for z in ZERO_ROWS
              for m, n, kw in ZERO_SHAPES[:3] for pair in MOE_PLANE_PAIRS]
    n_routed = 0
    for e, ec, n, kw, zeros, (ka, kb) in edges:
        a = expert_words((e, ka, ec, kw), 32 * kw, gen, dev)
        b = expert_words((e, kb, n, kw), 32 * kw, gen, dev)
        if zeros == "routed":
            gs = routed_group_sizes(ec // MOE_TOP_K, gen, dev)
            zero = torch.arange(ec, device=dev)[None, :] >= gs[:, None]
            a.masked_fill_(zero[:, None, :, None], 0)
            n_routed += int((gs == 0).sum())
        else:
            zero = zero_rows(a, zeros)
        s9 = kbit_gemm.kbit_plane_gemm_batched(a, b)
        s10 = kbit_mxu.kbit_mxu_gemm_batched(a, b)
        want = kbit_gemm.kbit_plane_gemm_batched_plain(a, b)
        torch.cuda.synchronize()
        where = (f"E={e} ec={ec} N={n} Kw={kw} ka={ka} kb={kb} zero rows "
                 f"{zeros}")
        check_exact({"kbit_plane_gemm_batched": [(s9, want)],
                     "kbit_mxu_gemm_batched": [
                         (s10, kbit_mxu.kbit_mxu_gemm_batched_plain(a, b)),
                         (s10, s9)]}, err, where)
        check_zero_rows("kbit_plane_gemm_batched", s9, zero, where)
        check_zero_rows("kbit_mxu_gemm_batched", s10, zero, where)
        n_cases += 1
        del a, b, s9, s10, want
    # (label, T, K, N, group sizes, capacities, stack forms): at the decode
    # shapes the forms the MoE layer calls (up + gate as one tuple, down
    # alone); the plain versions on the CPU are the costly side
    grouped = [
        ("decode up/gate", MOE_DECODE_EC, 2048, 1408,
         routed_group_sizes(DECODE_M, gen, dev), (None, 3), ("tuple",)),
        ("decode down", MOE_DECODE_EC, 1408, 2048,
         routed_group_sizes(DECODE_M, gen, dev), (None, 3), ("one",)),
        ("ragged", 48, 300, 70,
         torch.tensor([9, 0, 13, 1, 0, 11, 6, 4], device=dev), (None, 6, 2),
         ("one", "tuple")),
    ]
    n_grouped = 0
    for label, t, k, n, gs, caps, forms in grouped:
        e = gs.numel()
        x = dorefa_acts((t, k), gen, dev, 4)
        ws = tuple(expert_planes(e, n, k, 4, gen, dev)
                   for _ in range(2 if "tuple" in forms else 1))
        ws_cpu = tuple(w.cpu() for w in ws)
        for cap in caps:
            # the prologue's plane buckets and code sums, exactly; and at the
            # small shape the raw S of both kernels against the CPU's
            ec = cap or t
            dest, cell, _ = dispatch._bucket_cells(gs.long(), t, ec)
            bk = dispatch._pack_plane_buckets(x, 4, dest, cell, e, ec, True)
            bc = dispatch._pack_plane_buckets(x.cpu(), 4, dest.cpu(),
                                              cell.cpu(), e, ec, True)
            same = torch.equal(bk[0].cpu(), bc[0]) and torch.equal(
                bk[1].cpu(), bc[1])
            if label == "ragged":
                want = kbit_mxu.kbit_mxu_gemm_batched_plain(bc[0], ws_cpu[0])
                same = same and all(torch.equal(
                    fn(bk[0], ws[0]).cpu(), want) for fn in (
                        kbit_gemm.kbit_plane_gemm_batched,
                        kbit_mxu.kbit_mxu_gemm_batched))
            if not same:
                raise AssertionError(f"grouped w4a4 {label} capacity {cap}: "
                                     "buckets, code sums or S: card != CPU")
        for backend in ("vpu", "mxu"):
            cfg = dispatch.GemmConfig(backend=backend)
            for form in forms:
                stacks, cpu = (ws, ws_cpu) if form == "tuple" else (ws[0],
                                                                    ws_cpu[0])
                for cap in caps:
                    got = dispatch.quant_gemm_grouped(
                        x, stacks, gs, k_true=k, config=cfg,
                        expert_capacity=cap, w_bits=4, a_bits=4)
                    want = dispatch.quant_gemm_grouped(
                        x.cpu(), cpu, gs.cpu(), k_true=k, config=cfg,
                        expert_capacity=cap, w_bits=4, a_bits=4)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    for g_, w_ in zip(got, want):
                        if not torch.equal(g_.cpu(), w_):
                            raise AssertionError(
                                f"quant_gemm_grouped w4a4 {backend} {label} "
                                f"capacity {cap}: card != CPU")
                    n_grouped += 1
    print(f"parity: K9/K10 at {n_cases} (E, rows, N, Kw, ka, kb) cases "
          f"({len(TILE_CASES)} tile-edge shapes at E 2, routed buckets with "
          f"{n_routed} empty experts in all, rows zero in some planes or one "
          f"Kw slice) equal their plain versions and K9 == K10 exactly "
          f"(int32), S == 0 on every row zero in all planes; w4a4 "
          f"quant_gemm_grouped on the card == on the CPU in {n_grouped} calls"
          f" (vpu/mxu x full/tight capacity, route-first included; decode "
          f"up+gate tuple and down, a ragged case with both forms): plane "
          f"buckets and code sums exact, the dequantized output exact (its "
          f"numerator |2S - Nw*T| < 2^24 is exact in fp32, so equal outputs "
          f"with equal T mean equal S; S itself compared at the ragged case)")
    return err


def kv_storage(tier, shape, gen, dev):
    """K or V storage for one pool of unit-scale values: fp32 or bf16
    values, or ``kv_quantize`` codes and scales (``tier`` 8 or 1)."""
    from repro_torch.kernels import attn_decode

    x = torch.randn(shape, generator=gen, device=dev)
    if tier == "fp32":
        return x, None
    if tier == "bf16":
        return x.to(torch.bfloat16), None
    return attn_decode.kv_quantize(tier, x)


def attn_case(dev, gen, tier, layout, lens, c, g, dh, bps, kvh, holes):
    """One K11 call's operands (for ``attn_call``) and each slot's key
    positions in table order (B, L), -1 where there is no key.  Paged: a
    shuffled pool of ``len(lens) * bps`` blocks; with ``holes`` also three
    spare blocks holding stale positions, a -1 entry in the middle of slot
    0's table, and no mapped block at all for the last slot.  Contiguous:
    per-slot slabs.  Slot b holds positions ``0 .. lens[b]-1``; its queries
    are the last C of them."""
    b, bs = len(lens), PAGED_BLOCK
    lens_t = torch.as_tensor(lens, device=dev)
    span = torch.arange(bps * bs, dtype=torch.int32, device=dev)
    dense_pos = torch.where(span < lens_t[:, None], span, -1)  # (B, L)
    q = torch.randn((b, c, kvh, g, dh), generator=gen, device=dev)
    q_pos = (lens_t[:, None] - c + torch.arange(c, device=dev)).to(torch.int32)
    if layout == "contig":
        k, ks = kv_storage(tier, (b, bps * bs, kvh, dh), gen, dev)
        v, vs = kv_storage(tier, (b, bps * bs, kvh, dh), gen, dev)
        return dict(q=q, q_pos=q_pos, k=k, v=v, slot_pos=dense_pos,
                    k_scale=ks, v_scale=vs), dense_pos
    nb = b * bps + (3 if holes else 0)
    table = torch.randperm(nb, generator=gen, device=dev)[:b * bps]
    table = table.view(b, bps).to(torch.int32)
    if holes:
        table[0, bps // 2] = -1
        table[-1] = -1
    pool_pos = (torch.randint(0, bps * bs, (nb, bs), generator=gen, device=dev,
                              dtype=torch.int32) if holes else
                torch.full((nb, bs), -1, dtype=torch.int32, device=dev))
    mapped = table >= 0
    pool_pos[table[mapped].long()] = dense_pos.view(b, bps, bs)[mapped]
    k, ks = kv_storage(tier, (nb, bs, kvh, dh), gen, dev)
    v, vs = kv_storage(tier, (nb, bs, kvh, dh), gen, dev)
    kpos = torch.where(mapped[:, :, None], dense_pos.view(b, bps, bs), -1)
    return dict(table=table, q=q, q_pos=q_pos, pool_k=k, pool_v=v,
                pool_pos=pool_pos, k_scale=ks, v_scale=vs), kpos.view(b, -1)


def attn_call(plain: bool, layout: str, args: dict, tier, **opts):
    """K11 (``plain=False``: the wrapper, which launches the kernel) or its
    plain version on one case from :func:`attn_case`."""
    from repro_torch.kernels import attn_decode

    kv_bits = tier if isinstance(tier, int) else None
    if layout == "contig":
        fn = (attn_decode.flash_decode_contig_plain if plain
              else attn_decode.flash_decode_contig)
        return fn(**args, kv_bits=kv_bits, **opts)
    if plain:
        return attn_decode.flash_decode_paged_plain(**args, kv_bits=kv_bits,
                                                    **opts)
    return attn_decode.flash_decode_paged(**args, block_size=PAGED_BLOCK,
                                          kv_bits=kv_bits, **opts)


def visible(kpos, q_pos, window):
    """(B, C) bool: does query row (b, c) see any key (causal mask)?"""
    kp, qp = kpos[:, None, :], q_pos[:, :, None]
    ok = (kp >= 0) & (kp <= qp)
    if window is not None:
        ok &= kp > qp - window
    return ok.any(-1)


def parity_attn(dev) -> float:
    """K11 against its plain version over fp32 / bf16 / int8 / 1-bit pools,
    paged (block 16, 7 entries per slot, so split ranges and chunks span
    blocks and the last one is short) and contiguous, C in {1, 4, 256}, G in
    {1, 4}, Dh in {64, 128}, softcap and window each on and off, ragged
    lengths, a -1 entry mid-table and an unmapped slot; then a 128-entry
    table with short slots at C x G on both sides of the tile switch (most
    split ranges and window stages hold no key).  Rows that see a key must agree
    within 2e-5 (unit-scale inputs, the JAX test's tolerance; bf16 pools
    too: both sides read the same bf16 values, exact in fp32, so only the
    summation order differs), every output must be finite, and the unmapped
    slot must be exact zeros.  Returns the max |err|."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst, n = 0.0, 0
    for tier in ATTN_TIERS:
        for layout in ("paged", "contig"):
            for c in (1, 4, 256):
                for g in (1, 4):
                    for dh in (64, 128):
                        ragged = int(torch.randint(1, 7 * PAGED_BLOCK, (1,),
                                                   generator=gen, device=dev))
                        args, kpos = attn_case(
                            dev, gen, tier, layout, [7 * PAGED_BLOCK, ragged, 0],
                            c, g, dh, bps=7, kvh=2, holes=True)
                        for cap in (None, 30.0):
                            for window in (None, 40):
                                opts = dict(sm_scale=dh ** -0.5,
                                            logit_softcap=cap, window=window)
                                got = attn_call(False, layout, args, tier, **opts)
                                want = attn_call(True, layout, args, tier, **opts)
                                torch.cuda.synchronize()
                                where = (f"K11 {tier} {layout} C={c} G={g} "
                                         f"Dh={dh} cap={cap} window={window}")
                                vis = visible(kpos, args["q_pos"], window)
                                if not torch.isfinite(got).all():
                                    raise AssertionError(f"{where}: non-finite")
                                e = float((got[vis] - want[vis]).abs().max())
                                worst, n = max(worst, e), n + 1
                                if e > ATTN_TOL:
                                    raise AssertionError(
                                        f"{where}: max |err| {e} > {ATTN_TOL}")
                                if layout == "paged" and bool(got[-1].any()):
                                    raise AssertionError(
                                        f"{where}: unmapped slot not zero")
    # a 128-entry table (the serving cache) with short ragged slots, so that
    # most of the decode tile's split ranges and the window tile's stages
    # hold no key, at C*G on both sides of the tile switch
    tiles = {}
    for tier in ATTN_TIERS:
        for c, g in ((1, 4), (4, 4), (5, 4), (37, 4)):
            for dh in (64, 128):
                args, kpos = attn_case(
                    dev, gen, tier, "paged", [37, 300, 2 * c + 3, 0], c, g, dh,
                    bps=PAGED_CACHE_LEN // PAGED_BLOCK, kvh=2, holes=True)
                tile = attn_tile(args)
                for cap, window in ((None, None), (30.0, 40)):
                    opts = dict(sm_scale=dh ** -0.5, logit_softcap=cap,
                                window=window)
                    got = attn_call(False, "paged", args, tier, **opts)
                    want = attn_call(True, "paged", args, tier, **opts)
                    torch.cuda.synchronize()
                    where = (f"K11 {tier} long table C={c} G={g} Dh={dh} "
                             f"cap={cap} window={window} ({tile})")
                    vis = visible(kpos, args["q_pos"], window)
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{where}: non-finite")
                    e = float((got[vis] - want[vis]).abs().max())
                    worst, n = max(worst, e), n + 1
                    tiles[tile.split(",")[0]] = tiles.get(tile.split(",")[0], 0) + 1
                    if e > ATTN_TOL:
                        raise AssertionError(f"{where}: max |err| {e} > {ATTN_TOL}")
                    if bool(got[-1].any()):
                        raise AssertionError(f"{where}: unmapped slot not zero")
    print(f"parity: K11 at {n} cases (4 pools x 2 layouts x C 1/4/256 x G "
          f"1/4 x Dh 64/128 x softcap x window, then a 128-entry table with "
          f"slots of 37 / 300 / 2C+3 keys at C x G 1x4 / 4x4 / 5x4 / 37x4; "
          f"long-table cases per tile {tiles}) within {ATTN_TOL} of its "
          f"plain version on rows that see a key, unmapped slot exact zeros;"
          f" max |err| {worst:.3e}")
    return worst


def parity_attn_verify(dev) -> float:
    """K11 at the speculative verify's query windows: C 2, 3 and 5 with
    granite's G 4 and Dh 64 (C*G 8 and 12 in the decode tile, 20 in the
    window tile), every pool tier, paged and contiguous, ragged slot
    lengths (so each slot's C query rows carry their own positions), a -1
    entry mid-table and an unmapped slot.  Each case replays a rejected
    round through the layout's own cache operations first: a window of
    junk keys past each slot's length is written, ``truncate`` rolls the
    slot back to where the verify window starts, and ``fill_window``
    rewrites the window's C positions with new keys.  Rows that see a key
    must agree with the plain version within ``ATTN_TOL``; the unmapped
    slot must be exact zeros.  Returns the max |err|."""
    from repro_torch.nn import attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    g, dh, kvh, bps, junk = 4, 64, 2, 7, 3
    worst, n, tiles = 0.0, 0, {}
    for tier in ATTN_TIERS:
        kv_bits = tier if isinstance(tier, int) else None
        for layout in ("paged", "contig"):
            for c in (2, 3, 5):
                lens = [bps * PAGED_BLOCK - junk,
                        int(torch.randint(c + 1, bps * PAGED_BLOCK - junk, (1,),
                                          generator=gen, device=dev)), 0]
                args, _ = attn_case(dev, gen, tier, layout,
                                    [x + junk if x else 0 for x in lens], c,
                                    g, dh, bps, kvh, holes=True)
                names = (("pool_k", "pool_v", "pool_ks", "pool_vs", "pool_pos",
                          "table") if layout == "paged" else
                         ("k", "v", "k_scale", "v_scale", "slot_pos"))
                keys = (("pool_k", "pool_v", "k_scale", "v_scale", "pool_pos",
                         "table") if layout == "paged" else
                        ("k", "v", "k_scale", "v_scale", "slot_pos"))
                cache = {name: args[key] for name, key in zip(names, keys)
                         if args[key] is not None}
                kv = (attention.PagedKVCache(block_size=PAGED_BLOCK,
                                             kv_bits=kv_bits)
                      if layout == "paged" else
                      attention.ContiguousKVCache(kv_bits=kv_bits))
                lens_t = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                start = (lens_t - c).clamp(min=0)
                kv.truncate(cache, start)
                q_pos = (start[:, None] + torch.arange(
                    c, dtype=torch.int32, device=dev)).contiguous()
                k_new = torch.randn((3, c, kvh, dh), generator=gen, device=dev)
                v_new = torch.randn((3, c, kvh, dh), generator=gen, device=dev)
                kv.fill_window(cache, k_new, v_new, q_pos,
                               lens_t > 0)  # the empty slot writes nothing
                case = {**args, "q_pos": q_pos}
                for name, key in zip(names, keys):
                    if name in cache:
                        case[key] = cache[name]
                if layout == "paged":
                    tile = attn_tile(case).split(",")[0]
                    tiles[tile] = tiles.get(tile, 0) + 1
                got = attn_call(False, layout, case, tier, sm_scale=dh ** -0.5)
                want = attn_call(True, layout, case, tier, sm_scale=dh ** -0.5)
                torch.cuda.synchronize()
                where = f"K11 verify {tier} {layout} C={c} G={g} Dh={dh}"
                if layout == "paged":
                    kpos = torch.where(case["table"][:, :, None] >= 0,
                                       case["pool_pos"][case["table"].clamp(
                                           min=0).long()], -1).view(3, -1)
                else:
                    kpos = case["slot_pos"]
                vis = visible(kpos, q_pos, None)
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{where}: non-finite")
                if int(vis.sum()) != c * 2:
                    raise AssertionError(f"{where}: {int(vis.sum())} rows "
                                         f"see a key, expected {2 * c}")
                e = float((got[vis] - want[vis]).abs().max())
                worst, n = max(worst, e), n + 1
                if e > ATTN_TOL:
                    raise AssertionError(f"{where}: max |err| {e} > {ATTN_TOL}")
                if bool(got[-1].any()):
                    raise AssertionError(f"{where}: empty slot not zero")
    print(f"parity: K11 at the verify windows, {n} cases (4 pools x 2 layouts "
          f"x C 2/3/5, G 4, Dh 64; ragged slots, a junk window truncated and "
          f"the verify window rewritten through the cache's own truncate / "
          f"fill_window; paged cases per tile {tiles}) within {ATTN_TOL} of "
          f"the plain version on rows that see a key, empty slot exact zeros; "
          f"max |err| {worst:.3e}")
    return worst


def attn_tile(args: dict) -> str:
    """Which K11 tile a paged call takes, and the decode tile's split plan
    (``attn_decode.window_tile`` / ``split_plan``, the C entry point's
    rule)."""
    from repro_torch.kernels import attn_decode as ak

    b, c, kvh, g, dh = args["q"].shape
    if ak.window_tile(c, g, dh, args["pool_k"], args["pool_v"]):
        return "window tile"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, keys = ak.split_plan(b * kvh, c * g, args["pool_pos"].shape[1]
                            * args["table"].shape[1], sms)
    return f"decode tile, {n} splits of {keys} keys"


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


def graph_node_floor_ms(dev) -> float:
    """The least time one kernel node takes in :func:`graph_ms`: a
    one-element ``zero_`` (one fill kernel), 200 calls in one graph.  A
    kernel whose work is a few KB cannot take less; the prologues (K1, K4)
    print it beside their bound."""
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    return graph_ms(torch.Tensor.zero_, [(one,)], 200)


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


def timing(dev, popc_per_s: float, floor_ms: float, gemms=LAYER_GEMMS,
           families=FAMILIES, ms=(DECODE_M, PREFILL_M),
           model: str = "granite-3-2b") -> tuple[dict, list]:
    """Every kernel at the decode and prefill rows (``ms``) of each layer
    GEMM of ``model`` (``gemms``: granite-3-2b's by default), 1-bit
    (K1-K3), w4a4 and w8a8 (K4-K6; ``families`` picks the widths): kernel,
    plain version, the bf16
    yardstick and the bound; the prologues (K1, K4) also get the graph-node
    floor (``floor_ms``, :func:`graph_node_floor_ms`).  A GEMM's function is
    the integer dot of the codes, so its bound is the larger of its bytes
    at the HBM rate and ``2*M*N*K`` int8 operations at the tensor cores'
    peak, whichever kernel computes it; the popcount kernels (K2, K5) also
    get the ceiling of their own algorithm at the popc rate
    (``popc_bound_ms``), and K2 its carry-save ceiling (``csa_bound_ms``, 4
    popcounts per 8 word pairs) and its tile plan (``plan``).  K3 and K6 are
    timed again on one weight copy that stays in the L2 cache
    (``warm_ms``): a time that does not drop says device-memory bytes do
    not bound them.  The plain K5 runs ka*kb int64 popcount passes (about a
    second per prefill call at w8a8), so plain versions at prefill are
    timed once."""
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for bits, (pro, popc_gemm, mma_gemm) in families.items():
        for m in ms:
            plain_iters, plain_reps = (4, 5) if m == DECODE_M else (1, 1)
            for name, n, k in gemms:
                kw = (k + 31) // 32
                nw = copies_for(bits * n * kw * 4, 512)
                x, xp, wps, xb, wb = operands(bits, m, n, k, min(nw, 4), gen,
                                              dev)
                wps = [wps[i % len(wps)].clone() for i in range(nw)]
                nl = copies_for(n * k * 2, 64)
                wbs = [wb.clone() for _ in range(nl)]
                del wb
                row = {"model": model, "bits": bits, "m": m, "layer": name,
                       "n": n, "k": k}
                # the prologue reads x and writes the words (and, at k bits,
                # the code row-sums)
                args = (x,) if bits == 1 else (x, bits)
                row[pro] = dict(
                    ms=graph_ms(fns[pro][0], [args], 200),
                    plain_ms=graph_ms(fns[pro][1], [args], 5),
                    library_ms=None,
                    bytes=(m * k + bits * m * kw + (m if bits > 1 else 0)) * 4,
                    ops_s=0.0, floor_ms=floor_ms)
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
                if bits == 1:  # K2: its tile plan and carry-save ceiling
                    row[popc_gemm]["plan"] = xnor_gemm.describe_plan(
                        xnor_gemm.tile_plan(1, m, n, kw, sms))
                    row[popc_gemm]["csa_bound_ms"] = (
                        row[popc_gemm]["popc_bound_ms"] * CSA_POPC_PER_WORD)
                # K3 / K6: one weight copy, L2-resident
                row[mma_gemm]["warm_ms"] = graph_ms(
                    fns[mma_gemm][0], [(xp, wps[0])], nw)
                finish_row(row, FAMILIES[bits],
                           f"timing{'' if model == 'granite-3-2b' else ' ' + model}"
                           f" w{bits}a{bits} M={m} {name} N={n} K={k}")
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
        + ("" if "floor_ms" not in row[kn]
           else f" floor {row[kn]['floor_ms'] * 1e3:.3f}")
        + ("" if "popc_bound_ms" not in row[kn]
           else f" popc ceiling {row[kn]['popc_bound_ms'] * 1e3:.3f}")
        + ("" if "csa_bound_ms" not in row[kn]
           else f" carry-save ceiling {row[kn]['csa_bound_ms'] * 1e3:.3f}")
        + ("" if "plan" not in row[kn] else f" [{row[kn]['plan']}]")
        + ("" if "warm_ms" not in row[kn]
           else f" L2-warm {row[kn]['warm_ms'] * 1e3:.3f}")
        + ("" if "zero_ms" not in row[kn]
           else f" all-zero buckets {row[kn]['zero_ms'] * 1e3:.3f}")
        for kn in names))


def layer_total(rows: list, kname: str, m: int) -> dict:
    """One layer's 7 GEMM calls at ``m`` rows, summed for one kernel (K4-K6
    at w4a4): times, the bound of the summed bytes and operations, and the
    popcount / carry-save ceilings and the graph-node floor where the rows
    have them."""
    rs = [r[kname] for r in rows
          if r["m"] == m and r["bits"] in (1, 4) and kname in r]
    t_bytes = sum(r["bytes"] for r in rs) / HBM_BYTES_PER_S
    t_ops = sum(r["ops_s"] for r in rs)
    lib = [r["library_ms"] for r in rs]
    total = dict(ms=sum(r["ms"] for r in rs),
                 plain_ms=sum(r["plain_ms"] for r in rs),
                 bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=None if None in lib else sum(lib))
    for key in ("popc_bound_ms", "csa_bound_ms", "floor_ms"):
        if all(key in r for r in rs):
            total[key] = sum(r[key] for r in rs)
    return total


def decode_layer_totals(rows: list) -> dict:
    """The JSON line's numbers: one decode step of one layer (the 7 GEMMs'
    calls at M = batch), summed per kernel; K4-K6 at w4a4."""
    return {kname: layer_total(rows, kname, DECODE_M)
            for kname in ONE_BIT + K_BIT}


def print_layer_total(label: str, t: dict) -> None:
    print(f"{label} (us): kernel {t['ms'] * 1e3:.3f} plain "
          f"{t['plain_ms'] * 1e3:.3f} library "
          + ("-" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.3f}")
          + f" bound {t['bound_ms'] * 1e3:.3f} ({t['bound_by']})"
          + ("" if "floor_ms" not in t
             else f" graph-node floor {t['floor_ms'] * 1e3:.3f}")
          + ("" if "popc_bound_ms" not in t
             else f" popc ceiling {t['popc_bound_ms'] * 1e3:.3f}")
          + ("" if "csa_bound_ms" not in t
             else f" carry-save ceiling {t['csa_bound_ms'] * 1e3:.3f}"))


def timing_prologues(dev, floor_ms: float) -> list:
    """K1 and K4 (w4a4) at the MoE cell's prologue shapes
    (``PROLOGUE_SHAPES``): kernel, plain version, bound (bytes) and the
    graph-node floor."""
    from repro_torch.kernels import pack_bits

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = []
    for m, k in PROLOGUE_SHAPES:
        kw = (k + 31) // 32
        row = {"m": m, "k": k}
        x = torch.randn((m, k), generator=gen, device=dev)
        xq = dorefa_acts((m, k), gen, dev, 4)
        for name, fn, plain, args, out_words in (
                ("pack_sign", pack_bits.pack_sign, pack_bits.pack_sign_plain,
                 (x,), m * kw),
                ("quant_pack_planes", pack_bits.quant_pack_planes,
                 pack_bits.quant_pack_planes_plain, (xq, 4), 4 * m * kw + m)):
            row[name] = dict(ms=graph_ms(fn, [args], 200),
                             plain_ms=graph_ms(plain, [args], 5),
                             library_ms=None, bytes=(m * k + out_words) * 4,
                             ops_s=0.0, floor_ms=floor_ms)
        finish_row(row, ("pack_sign", "quant_pack_planes"),
                   f"timing prologues M={m} K={k} (K4 w4a4)")
        rows.append(row)
    return rows


def event_ms(fn, args: dict, reps: int = 3) -> float:
    """Median time of one eager call between CUDA events (for the plain
    versions, whose host-side loop cannot be captured in a graph)."""
    fn(**args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(**args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kv_row_bytes(tier, dh: int) -> int:
    """Bytes of one cached row of one kv-head, K or V, with its scale."""
    return {"fp32": 4 * dh, "bf16": 2 * dh,
            8: dh + 4 * (dh // 32 if dh % 32 == 0 else 1), 1: dh // 8 + 4}[tier]


def timing_attn(dev, kvh: int = 8, g: int = 4, dh: int = 64,
                cs=(1, SPEC_VERIFY_C[0], SPEC_VERIFY_C[1], PAGED_CHUNK),
                tiers=ATTN_TIERS, full_cache_row: bool = True,
                model: str = "granite-3-2b") -> list:
    """K11 at the paged serving shapes — batch 4, ``kvh`` kv-heads of
    ``dh``, ``g`` query heads each (granite-3-2b's 8 / 64 / 4 by default),
    a 2,048-row cache of 128 blocks of 16 per slot, all mapped as admission
    maps them, ragged lengths from the serving mix — at decode (C 1), the
    verify windows (C 3, 5) and one prefill window (C 256, the last chunk
    of each prompt) (``cs``), per pool tier (``tiers``); then
    (``full_cache_row``) decode at the full cache (every slot 2,048 keys
    long, the shape ``profile_decode`` measures).  Each row names the tile
    and split plan.
    Each row: the kernel (pool copies cycled to overflow the L2 cache, as
    40 layers read their pools cold), the plain version, the library
    yardstick (``scaled_dot_product_attention`` on the dense gathered fp32
    K/V with the ``_mask`` mask and GQA; the port never calls it), and the
    bound: the larger of the bytes (K/V codes and scales of every row the
    mask admits, the pool_pos of mapped blocks, the table, q, q_pos, out) at
    the HBM rate and 4*G*Dh fp32 operations per (query row, admitted key,
    kv-head) at the fp32 peak.  Each row is also a parity gate at these
    shapes: the kernel's output must agree with the plain version's within
    ``ATTN_TOL`` on every query row that sees a key, and be finite."""
    import torch.nn.functional as F

    from repro_torch.kernels import attn_decode as ak

    b, bps = DECODE_M, PAGED_CACHE_LEN // PAGED_BLOCK
    rng = np.random.default_rng(SEED + 5)
    lens = [int(x) for x in rng.integers(PREFIX_LEN + TAIL_LENS[0],
                                         PREFIX_LEN + TAIL_LENS[1] + 1, b)]
    sm = dh ** -0.5
    rows = []
    shapes = [(c, "serving", lens) for c in cs]
    if full_cache_row:
        shapes.append((1, "full cache", [PAGED_CACHE_LEN] * b))
    for c, cache, lens in shapes:
        for tier in tiers:
            gen = torch.Generator(device=dev).manual_seed(SEED + 6)
            args, kpos = attn_case(dev, gen, tier, "paged", lens, c, g, dh,
                                   bps, kvh, holes=False)
            tile = attn_tile(args)
            got = attn_call(False, "paged", args, tier, sm_scale=sm)
            want = attn_call(True, "paged", args, tier, sm_scale=sm)
            torch.cuda.synchronize()
            vis = visible(kpos, args["q_pos"], None)
            if not torch.isfinite(got).all():
                raise AssertionError(f"K11 {tier} C={c} serving shapes: "
                                     "non-finite output")
            max_err = float((got[vis] - want[vis]).abs().max())
            if max_err > ATTN_TOL:
                raise AssertionError(f"K11 {tier} C={c} serving shapes: max "
                                     f"|err| {max_err} > {ATTN_TOL}")
            del got, want
            pool_bytes = 2 * args["pool_pos"].numel() * kvh * kv_row_bytes(tier, dh)
            copies = [args] + [
                {**args, **{k: args[k].clone() for k in
                            ("pool_k", "pool_v", "k_scale", "v_scale")
                            if args[k] is not None}}
                for _ in range(copies_for(pool_bytes, 64) - 1)]
            ms = graph_ms(lambda a: attn_call(False, "paged", a, tier,
                                              sm_scale=sm),
                          [(a,) for a in copies], max(2 * len(copies), 20))
            plain_ms = event_ms(lambda **a: attn_call(True, "paged", a, tier,
                                                      sm_scale=sm), args)
            # library yardstick on the dense gathered, dequantized K/V
            adm = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= args["q_pos"][:, :, None])
            safe = args["table"].clamp(min=0).long()

            def dense(pool, scale):
                x = pool[safe]
                if isinstance(tier, int):
                    x = ak.kv_dequantize(tier, x, scale[safe], dh)
                return x.float().reshape(b, -1, kvh, dh).transpose(1, 2).contiguous()

            k_d = dense(args["pool_k"], args["k_scale"])
            v_d = dense(args["pool_v"], args["v_scale"])
            q_h = args["q"].permute(0, 2, 3, 1, 4).reshape(b, kvh * g, c, dh)
            n_lib = copies_for(2 * k_d.numel() * 4, 8)
            lib_sets = [(q_h, k_d.clone(), v_d.clone(), adm[:, None])
                        for _ in range(n_lib)]
            library_ms = graph_ms(
                lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
                    q_, k_, v_, attn_mask=m_, scale=sm, enable_gqa=True),
                lib_sets, max(2 * n_lib, 20))
            keys_any = adm.any(1)  # (B, L): rows some query of the slot admits
            n_blocks = int((args["table"] >= 0).sum())
            nbytes = (int(keys_any.sum()) * kvh * 2 * kv_row_bytes(tier, dh)
                      + n_blocks * PAGED_BLOCK * 4 + args["table"].numel() * 4
                      + 2 * args["q"].numel() * 4 + args["q_pos"].numel() * 4)
            ops = 4 * g * dh * kvh * int(adm.sum())
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
            row = dict(model=model, kvh=kvh, g=g, dh=dh, c=c, cache=cache,
                       tile=tile, tier=str(tier), lens=lens,
                       max_abs_err=max_err,
                       ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bytes=nbytes, ops=ops,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       copies=len(copies))
            rows.append(row)
            print(f"timing K11 {'' if model == 'granite-3-2b' else model + ' '}"
                  f"{tier} C={c} {cache} (B {b}, KVH {kvh}, G {g}, "
                  f"Dh {dh}, lens {lens}; {tile}) (us): kernel {ms * 1e3:.3f} plain "
                  f"{plain_ms * 1e3:.3f} library {library_ms * 1e3:.3f} bound "
                  f"{row['bound_ms'] * 1e3:.3f} ({row['bound_by']}: "
                  f"{nbytes} bytes, {ops} flops); max |err| vs plain "
                  f"{max_err:.3e} on {int(vis.sum())} visible rows")
            del copies, lib_sets, k_d, v_d
    return rows


def moe_operands(bits: int, e: int, ec: int, n: int, k: int, gen, dev):
    """One expert GEMM's operands: the packed buckets (E, ec, Kw) at 1 bit
    or (E, 4, ec, Kw) plane buckets at w4a4, the packed expert stack, and
    the yardstick's bf16 operands, the values the packed GEMM contracts:
    (E, ec, K) activations and (E, K, N) weights."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import pack_bits

    if bits == 1:
        a = bitpack.pack_sign(torch.randn((e, ec, k), generator=gen,
                                          device=dev))
        w = bitpack.pack_sign(torch.randn((e, n, k), generator=gen,
                                          device=dev))
        return (a, w, bitpack.unpack_sign(a, k, torch.bfloat16),
                bitpack.unpack_sign(w, k, torch.bfloat16).transpose(1, 2))
    x = dorefa_acts((e * ec, k), gen, dev, bits)
    a, _ = pack_bits.quant_pack_planes(x, bits)
    a = a.reshape(bits, e, ec, -1).transpose(0, 1).contiguous()
    w = expert_planes(e, n, k, bits, gen, dev)
    nq = float((1 << bits) - 1)
    xq = bitpack.unpack_planes(a.movedim(1, 0), k).to(torch.float32) / nq
    wq = (2 * bitpack.unpack_planes(w.movedim(1, 0), k).to(torch.float32)
          - nq) / nq
    return a, w, xq.to(torch.bfloat16), wq.transpose(1, 2).to(torch.bfloat16)


def timing_moe(dev, popc_per_s: float) -> tuple[dict, list]:
    """K7 / K8 (1 bit) and K9 / K10 (w4a4) at deepseek-moe-16b's expert
    GEMMs (64 experts; up / gate N 1408 K 2048, down N 2048 K 1408), at
    decode (24 bucket rows: 4 tokens x top-6, the single-device capacity
    T*k) and at the mix's largest prefill run (576 rows: 96 tokens x
    top-6): kernel, plain version, the bf16 ``torch.bmm`` yardstick on the
    same (E, rows, K) x (E, K, N) values (±1, or the dequantized DoReFa
    codes), and the bound — the larger of the bytes (expert words or
    planes, bucket words, int32 output) at the HBM rate and
    ``2*E*rows*N*K`` int8 operations at the tensor cores' peak (the
    function is the integer dot of the codes); the popcount kernels' (K7,
    K9) own ceiling at the popc rate is printed beside it, ka*kb = 16 times
    K7's for K9, with K7's carry-save ceiling and tile plan, and K8's and
    K10's time on one L2-resident weight stack (``warm_ms``) as for K3.  Weight stacks cycle through enough copies to
    overflow the L2 cache, as 27 MoE layers read their experts cold.
    Returns (one decode step of one MoE layer per kernel: up + gate + down,
    rows)."""
    from repro_torch.kernels import kbit_gemm, kbit_mxu, xnor_gemm

    fns = {"xnor_mismatch_batched": (xnor_gemm.xnor_mismatch_batched,
                                     xnor_gemm.xnor_mismatch_batched_plain),
           "xnor_dot_mxu_batched": (xnor_gemm.xnor_dot_mxu_batched,
                                    xnor_gemm.xnor_dot_mxu_batched_plain),
           "kbit_plane_gemm_batched": (kbit_gemm.kbit_plane_gemm_batched,
                                       kbit_gemm.kbit_plane_gemm_batched_plain),
           "kbit_mxu_gemm_batched": (kbit_mxu.kbit_mxu_gemm_batched,
                                     kbit_mxu.kbit_mxu_gemm_batched_plain)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    e, rows = MOE_EXPERTS, []
    for bits, names in ((1, MOE_KERNELS), (4, MOE_KBIT_KERNELS)):
        for ec in (MOE_DECODE_EC, MOE_PREFILL_EC):
            plain_iters, plain_reps = (2, 3) if ec == MOE_DECODE_EC else (1, 1)
            for name, n, k in MOE_GEMMS[1:]:  # up has gate's shape: timed once
                kw = (k + 31) // 32
                a, w0, xb, wb = moe_operands(bits, e, ec, n, k, gen, dev)
                nw = copies_for(bits * e * n * kw * 4, 64)
                ws = [w0] + [w0.clone() for _ in range(nw - 1)]
                nl = copies_for(e * n * k * 2, 8)
                wbs = [wb.contiguous()] + [wb.contiguous()
                                           for _ in range(nl - 1)]
                del wb
                lib_ms = graph_ms(torch.bmm, [(xb, w) for w in wbs], 2 * nl)
                routed = None
                if bits > 1 and ec == MOE_DECODE_EC:
                    ra, rxb, gs = routed_buckets(bits, k, gen, dev)
                    routed = (ra, gs, graph_ms(torch.bmm, [
                        (rxb, w) for w in wbs], 2 * nl))
                    del rxb
                del wbs
                row = {"bits": bits, "m": ec, "layer": "up/gate"
                       if name == "gate" else name, "e": e, "n": n, "k": k,
                       "copies": nw, "routed": False}
                for kname in names:
                    kernel, plain = fns[kname]
                    row[kname] = dict(
                        ms=graph_ms(kernel, [(a, w) for w in ws], 4 * nw),
                        plain_ms=graph_ms(plain, [(a, w0)], plain_iters,
                                          reps=plain_reps),
                        library_ms=lib_ms,
                        bytes=(bits * (e * n * kw + e * ec * kw)
                               + e * ec * n) * 4,
                        ops_s=2 * e * ec * n * k / INT8_OPS_PER_S)
                row[names[0]]["popc_bound_ms"] = (
                    bits * bits * e * ec * n * kw / popc_per_s * 1e3)
                if bits == 1:  # K7: its tile plan and carry-save ceiling
                    row[names[0]]["plan"] = xnor_gemm.describe_plan(
                        xnor_gemm.tile_plan(e, ec, n, kw, sms))
                    row[names[0]]["csa_bound_ms"] = (
                        row[names[0]]["popc_bound_ms"] * CSA_POPC_PER_WORD)
                # K8 / K10: one weight stack, L2-resident
                row[names[1]]["warm_ms"] = graph_ms(
                    fns[names[1]][0], [(a, w0)], 4 * nw)
                width = "1-bit" if bits == 1 else f"w{bits}a{bits}"
                finish_row(row, names, f"timing MoE {width} E={e} rows={ec} "
                           f"{row['layer']} N={n} K={k}")
                rows.append(row)
                if routed:
                    rows.append(routed_row(names, fns, routed, ws, row,
                                           popc_per_s))
                del ws, a, xb, routed
    totals = {}
    for kname in MOE_KERNELS + MOE_KBIT_KERNELS:
        # one decode step of one MoE layer: up + gate (one row, twice) + down
        rs = [(2 if r["layer"] == "up/gate" else 1, r[kname]) for r in rows
              if r["m"] == MOE_DECODE_EC and kname in r and not r["routed"]]
        t_bytes = sum(c * r["bytes"] for c, r in rs) / HBM_BYTES_PER_S
        t_ops = sum(c * r["ops_s"] for c, r in rs)
        totals[kname] = dict(
            ms=sum(c * r["ms"] for c, r in rs),
            plain_ms=sum(c * r["plain_ms"] for c, r in rs),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=sum(c * r["library_ms"] for c, r in rs))
        for key in ("popc_bound_ms", "csa_bound_ms"):
            if all(key in r for _, r in rs):
                totals[kname][key] = sum(c * r[key] for c, r in rs)
    print_layer_total("timing K7 per MoE decode layer (up + gate + down, "
                      f"{MOE_DECODE_EC} bucket rows)",
                      totals["xnor_mismatch_batched"])
    return totals, rows


def routed_buckets(bits: int, k: int, gen, dev):
    """Decode buckets of a seeded top-6 routing of 4 tokens over 64
    experts, built as ``quant_gemm_grouped`` builds them (``_bucket_cells``
    + ``_pack_plane_buckets``): each expert's rows at the front of its
    24-row bucket, zero planes behind them, the experts that got no token
    all zero.  Returns the (E, bits, 24, Kw) plane buckets, their bf16
    dequantized values (E, 24, K) for the yardstick, and the group
    sizes."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import dispatch

    gs = routed_group_sizes(DECODE_M, gen, dev)
    x = dorefa_acts((MOE_DECODE_EC, k), gen, dev, bits)
    dest, cell, _ = dispatch._bucket_cells(gs, MOE_DECODE_EC, MOE_DECODE_EC)
    a, _ = dispatch._pack_plane_buckets(x, bits, dest, cell, MOE_EXPERTS,
                                        MOE_DECODE_EC, True)
    xq = bitpack.unpack_planes(a.movedim(1, 0), k).to(torch.float32)
    return a, (xq / float((1 << bits) - 1)).to(torch.bfloat16), gs


def routed_row(names, fns, routed, ws, dense: dict, popc_per_s: float):
    """K9 / K10 on the routed decode buckets of :func:`routed_buckets`
    against the dense row's weight copies.  The bound counts what this
    routing needs: the planes of the experts that got a token, the buckets
    and the output at the HBM rate, and ``2*routed rows*N*K`` int8
    operations (K9's popcount ceiling likewise); the bf16 ``torch.bmm``
    yardstick (``library_ms``, timed on the same buckets) still computes
    every bucket row.  K9 and K10 are timed once more on all-zero buckets
    (``zero_ms``), the floor of their zero-row skip."""
    a, gs, lib_ms = routed
    e, bits, ec, kw = a.shape
    n, k = dense["n"], dense["k"]
    touched, rows = int((gs > 0).sum()), int(gs.sum())
    plane_bytes = bits * touched * n * kw * 4
    row = dict(dense, routed=True, experts_touched=touched, routed_rows=rows,
               touched_plane_bytes=plane_bytes)
    for kname in names:
        kernel, plain = fns[kname]
        row[kname] = dict(
            ms=graph_ms(kernel, [(a, w) for w in ws], 4 * len(ws)),
            plain_ms=graph_ms(plain, [(a, ws[0])], 2, reps=3),
            library_ms=lib_ms,
            bytes=plane_bytes + (bits * e * ec * kw + e * ec * n) * 4,
            ops_s=2 * rows * n * k / INT8_OPS_PER_S)
    row[names[0]]["popc_bound_ms"] = (
        bits * bits * rows * n * kw / popc_per_s * 1e3)
    # on buckets whose rows are all zero: what the zero-row skip costs with
    # no row to contract (every block stages its rows, stores zeros)
    zero = torch.zeros_like(a)
    for kname in names:
        row[kname]["zero_ms"] = graph_ms(fns[kname][0],
                                         [(zero, w) for w in ws], 4 * len(ws))
    finish_row(row, names, f"timing MoE w{bits}a{bits} E={e} rows={ec} "
               f"routed ({rows} rows, {touched} experts touched, "
               f"{plane_bytes / 1e6:.3f} MB of their planes) {row['layer']} "
               f"N={n} K={k}")
    return row


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------


def mix_prompts(vocab: int) -> list:
    """The granite cells' request mix (``PROMPT_LENS``) over ``vocab``."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def serve_mix(spec, cfg, policy, runs_spec, prompts, tag: str,
              ref_label: str = "fake-quant", profile=True,
              cache_len: int = CACHE_LEN):
    """Serve ``prompts`` once per (label, params, backend[, batch]) in
    ``runs_spec`` under ``policy`` (batch: slots, default 4) on a
    ``cache_len``-row contiguous cache; the kernel counts and the
    peak-memory counter are set to 0 just before each run and read just
    after.  ``profile``: True, or the labels whose decode step is
    profiled.  Checks the ``ref_label`` run's streams.  Returns (runs,
    launches) keyed by label; a run's ``ttft_s`` is its first request's
    time to first token (the prefill, for one request)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.nn.common import QCtx
    from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                          Scheduler)

    runs, launches = {}, {}
    for label, p, backend, *batch in runs_spec:
        ecfg = EngineConfig(batch=batch[0] if batch else DECODE_M,
                            cache_len=cache_len, max_new_tokens=NEW_TOKENS)
        ctx = QCtx(policy=policy, compute_dtype=torch.float32,
                   gemm_config=GemmConfig(backend=backend))
        eng = Engine(spec, cfg, ctx, p, ecfg)
        sched = Scheduler(eng)
        for pr in prompts:
            sched.submit(Request(prompt=pr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[label] = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_tok = sum(len(v) for v in results.values())
        tpot = statistics.median(sched.stats.tpots()) * 1e3
        runs[label] = dict(results=results, seconds=dt, tokens=n_tok,
                           tok_s=n_tok / dt, decode_ms_step=tpot,
                           ttft_s=sched.stats.ttfts()[0],
                           steps=sched.stats.steps,
                           prefills=sched.stats.prefills,
                           batch=ecfg.batch, peak_memory_gb=peak)
        print(f"serving {tag}{label}: {n_tok} tokens in {dt:.4f}s = "
              f"{n_tok / dt:.3f} tok/s; decode {tpot:.4f} ms/step (median "
              f"inter-token gap); {sched.stats.steps} decode steps, "
              f"{sched.stats.prefills} prefills, {ecfg.batch} slots; peak "
              f"memory {peak:.3f} GB; launches "
              f"{ {k: v for k, v in launches[label].items() if v} }")
        if profile is True or label in profile:
            runs[label]["decode_profile"] = profile_decode(eng, tag + label)
    ref = runs[ref_label]["results"]
    if sorted(ref) != list(range(len(prompts))):
        raise AssertionError(f"{tag}missing requests: {sorted(ref)}")
    for rid, toks in ref.items():
        if len(toks) != NEW_TOKENS or not ((toks >= 0)
                                           & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{tag}rid {rid}: bad stream {toks}")
    return runs, launches


def train_step_card_vs_cpu(dev) -> dict:
    """One quickstart-settings step of granite-3-2b smoke (binary, fp32) on
    the card and on the CPU from the same numpy init and batch, held to
    ``TRAIN_TOL``.  Returns the largest errors."""
    from repro_torch.data import synthetic
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch import quickstart
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves

    spec = registry.get("granite-3-2b")
    cfg = spec.smoke
    host = params_to_numpy(trainer.init_all(
        spec, cfg, torch.Generator().manual_seed(SEED))[0])
    batch = synthetic.batch_at(synthetic.DataConfig(
        cfg.vocab_size, quickstart.SEQ, quickstart.BATCH, seed=SEED), 0)
    step = trainer.make_train_step(spec, cfg, quickstart.CTX, quickstart.OPT,
                                   remat=True, bit_flip_metrics_on=True)
    out = []
    for d in ("cpu", dev):
        params = params_from_numpy(host, d)
        out.append(step(params, adamw.init(params), batch))
    (cp, co, cm), (gp, go, gm) = out
    lr = cm["lr"].item()
    err = {k: abs(gm[k].item() - cm[k].item()) / abs(cm[k].item())
           for k in ("loss", "grad_norm")}
    err["moments (share of leaf max)"] = max(
        ((g.cpu() - c).abs().max() / c.abs().max()).item()
        for k in ("m", "v")
        for g, c in zip(tree_leaves(go[k]), tree_leaves(co[k])))
    big_err = all_err = 0.0
    for g, c, m in zip(tree_leaves(gp), tree_leaves(cp), tree_leaves(co["m"])):
        d = (g.cpu().double() - c.double()).abs()
        big = m.abs() > 1e-3 * m.abs().max()
        all_err = max(all_err, d.max().item() / lr)
        if big.any():
            big_err = max(big_err, d[big].max().item() / lr)
    err["params, |m| above 1e-3 of max (x lr)"] = big_err
    err["params, all (x lr)"] = all_err
    ok = (err["loss"] <= TRAIN_TOL["loss_rtol"]
          and err["grad_norm"] <= TRAIN_TOL["gnorm_rtol"]
          and err["moments (share of leaf max)"] <= TRAIN_TOL["moment_rel"]
          and big_err <= 1e-3 and all_err <= 2.0
          and gm["lr"].item() == lr and go["step"].item() == 1)
    print(f"training: smoke step card vs CPU (binary, fp32, remat): {err}; "
          f"bit_flip_rate card {gm['bit_flip_rate'].item():.6f} CPU "
          f"{cm['bit_flip_rate'].item():.6f}")
    if not ok:
        raise AssertionError(f"smoke train step on the card differs from the "
                             f"CPU beyond {TRAIN_TOL}: {err}")
    return err


def training(dev) -> dict:
    """Phase "training": the card against the CPU at smoke size, then
    full-width granite-3-2b trained for ``TRAIN_STEPS`` steps (remat,
    1-bit with XNOR-Net alpha, fp32 master and compute), converted, and
    served packed on K1 + K2 and K1 + K3 and fake-quant; the packed export
    is loaded back and served again.  Every stream must be identical
    (§2.2.2)."""
    import gc

    from repro_torch.ckpt.manager import export_packed
    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data import synthetic
    from repro_torch.launch.serve import load_packed, packed_template
    from repro_torch.models import registry
    from repro_torch.nn.common import QCtx
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves

    summary = {"smoke step card vs CPU": train_step_card_vs_cpu(dev)}
    spec = registry.get("granite-3-2b")
    cfg = spec.config
    dcfg = synthetic.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                seed=SEED)

    def init_and_step(policy):
        params, opt_state = trainer.init_all(
            spec, cfg, torch.Generator(device=dev).manual_seed(SEED))
        return params, opt_state, trainer.make_train_step(
            spec, cfg, QCtx(policy=policy, compute_dtype=torch.float32),
            adamw.AdamWConfig(**TRAIN_OPT), remat=True,
            bit_flip_metrics_on=True)

    # Without alpha every ±1 GEMM scales the backward signal by about
    # sqrt(K) (45-90 here), and 40 layers of that overflow fp32: one step
    # shows it (reported, not gated); the cell trains with XNOR-Net alpha.
    params, opt_state, step_fn = init_and_step(QuantPolicy.binary())
    m = step_fn(params, opt_state, synthetic.batch_at(dcfg, 0))[2]
    unscaled = {k: m[k].item() for k in ("loss", "grad_norm")}
    print(f"training: QuantPolicy.binary() without alpha, one full-width "
          f"step: {unscaled} (finite grad norm: "
          f"{math.isfinite(unscaled['grad_norm'])})")
    summary["binary() without alpha, one step"] = unscaled
    del params, opt_state, step_fn, m
    torch.cuda.empty_cache()

    binary = QuantPolicy.binary(scale=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, step_fn = init_and_step(binary)
    n_params = sum(x.numel() for x in tree_leaves(params))
    watch = {k: params["layers"][k[0]]["mlp"][k[1]]["w"].clone()
             for k in ((0, "down"), (cfg.n_layers - 1, "up"))}
    watch["embed"] = params["embed"]["table"].clone()
    torch.cuda.synchronize()
    print(f"training: granite-3-2b full width, {cfg.n_layers} layers, "
          f"{n_params} params, QuantPolicy.binary(scale=True), fp32; init "
          f"{time.perf_counter() - t0:.3f}s; remat, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens a step, AdamW {TRAIN_OPT}")
    steps = []
    for i in range(TRAIN_STEPS):
        batch = synthetic.batch_at(dcfg, i)
        if i == TRAIN_STEPS - 1:  # the last step under the profiler
            by_name, (params, opt_state, m) = device_time_by_kernel(
                lambda: step_fn(params, opt_state, batch))
            steps.append({k: m[k].item() for k in (
                "loss", "grad_norm", "bit_flip_rate", "lr")})
            print(f"training step {i + 1} (profiled): "
                  f"loss={steps[-1]['loss']:.6f}")
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        row = {k: m[k].item() for k in ("loss", "grad_norm", "bit_flip_rate",
                                        "lr")}
        row["ms"] = ms
        steps.append(row)
        print(f"training step {i + 1}: loss={row['loss']:.6f} grad_norm="
              f"{row['grad_norm']:.6f} bit_flip_rate="
              f"{row['bit_flip_rate']:.8f} lr={row['lr']:.3e} {ms:.3f} ms")
    peak = torch.cuda.max_memory_allocated() / 1e9
    median_ms = statistics.median(r["ms"] for r in steps[1:-1])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3)
    by_name = {k: ms for k, (ms, _) in by_name.items()}
    device_ms = sum(by_name.values())
    gemm_ms = sum(v for k, v in by_name.items() if "gemm" in k.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"training profile (step {TRAIN_STEPS}): device {device_ms:.3f} ms, "
          f"busy share {device_ms / median_ms:.4f} of the median step; "
          f"kernels named *gemm* {gemm_ms:.3f} ms; top: "
          + "; ".join(f"{k[:70]} {v:.3f}ms" for k, v in top))
    def now(k):
        if k == "embed":
            return params["embed"]["table"]
        return params["layers"][k[0]]["mlp"][k[1]]["w"]

    changed = {k: not torch.equal(v, now(k)) for k, v in watch.items()}
    print(f"training: median step {median_ms:.3f} ms after the first = "
          f"{tok_s:.3f} tokens/s; peak memory (max_memory_allocated) "
          f"{peak:.3f} GB; master changed {changed}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"non-finite training loss: {steps}")
    if not steps[0]["bit_flip_rate"] > 0 or not all(changed.values()):
        raise AssertionError("the full-width step did not move the master")
    summary["full width"] = dict(
        steps=steps, median_step_ms=median_ms, tokens_per_s=tok_s,
        peak_memory_gb=peak, params=n_params, device_ms=device_ms,
        gemm_ms=gemm_ms,
        top_kernels_ms=[[k[:90], v] for k, v in top])
    del opt_state, watch, m
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    packed, report = converter.convert(params, binary)
    torch.cuda.synchronize()
    print(f"training: trained model converted in "
          f"{time.perf_counter() - t0:.3f}s; {report.summary()}")
    prompts = mix_prompts(cfg.vocab_size)
    runs, launches = serve_mix(
        spec, cfg, binary, (("packed-vpu", packed, "vpu"),
                            ("packed-mxu", packed, "mxu"),
                            ("fake-quant", params, "vpu")), prompts,
        "trained ", profile=())
    for label in ("packed-vpu", "packed-mxu"):
        if not same_streams(runs, label, "fake-quant"):
            raise AssertionError(f"§2.2.2 violated on the trained model: "
                                 f"{label} != fake-quant")
    lv, lm_, lf = (launches[k] for k in ("packed-vpu", "packed-mxu",
                                          "fake-quant"))
    if not (lv["pack_sign"] > 0 and lv["xnor_mismatch"] > 0
            and lm_["pack_sign"] > 0 and lm_["xnor_dot_mxu"] > 0
            and not any(lf.values())):
        raise AssertionError(f"trained 1-bit serving did not run through "
                             f"K1 / K2 / K3: {launches}")
    print("training: trained model's greedy streams identical for "
          "packed-vpu, packed-mxu and fake-quant (§2.2.2)")

    path = ROOT / "build" / "trained_granite_3_2b.packed.npz"
    t0 = time.perf_counter()
    export_packed(params, binary, str(path))
    size = path.stat().st_size
    del params
    gc.collect()
    torch.cuda.empty_cache()
    loaded = load_packed(str(path), packed_template(cfg, binary), dev)
    path.unlink()
    print(f"training: export_packed + load_packed {size} bytes in "
          f"{time.perf_counter() - t0:.3f}s")
    runs_npz, _ = serve_mix(spec, cfg, binary,
                            (("packed-vpu from .npz", loaded, "vpu"),),
                            prompts, "trained ", "packed-vpu from .npz",
                            profile=())
    runs["packed-vpu from .npz"] = runs_npz["packed-vpu from .npz"]
    if not same_streams(runs, "packed-vpu from .npz", "packed-vpu"):
        raise AssertionError("the exported / loaded packed model serves "
                             "other tokens than the converted one")
    print("training: exported and loaded packed model serves the same "
          "greedy streams")
    summary["serving the trained model"] = {
        k: {kk: vv for kk, vv in v.items() if kk != "results"}
        for k, v in runs.items()}
    summary["npz bytes"] = size
    return summary


def serving_moe(dev) -> tuple[dict, dict]:
    """The MoE cell: deepseek-moe-16b at full width (d_model 2048, 16 heads
    of 128, vocab 102400; layer 0 a dense FFN of 10944; 64 routed experts
    of 1408, top-6, and 2 shared experts per MoE layer), 1-bit
    (``QuantPolicy.binary()``), float32 compute, the granite cells'
    request mix on 4 slots of a 256-row contiguous cache, gather
    attention.  Runs, each with its kernel counts set to 0 just before it:

    - all 28 layers, packed ``vpu`` and ``mxu`` (built layer by layer,
      ``lm.init_packed``): their greedy streams must be identical (the
      same integer dots);
    - depth 4 (layer 0 + 3 MoE layers, full width): packed ``vpu``, packed
      ``mxu``, fake-quant and packed ``vpu`` again; all four streams must
      be identical (§2.2.2, and a repeat run repeats: stable sort,
      fixed-order combine); packed ``vpu`` one slot at a time is reported
      beside them.

    Launch gates: K7 == 3 x MoE layers x (decode steps + prefill calls) on
    the ``vpu`` runs and 0 on the others, K8 likewise on ``mxu``, K1 on
    every packed run, nothing on fake-quant.  Returns (K7 / K8 / K1
    launches of the full-depth runs, summary)."""
    import dataclasses

    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.launch.serve import stream_agreement
    from repro_torch.models import lm, registry
    from repro_torch.nn.common import QCtx

    spec = registry.get(MOE_ARCH)
    cfg = spec.config
    widths = (cfg.d_model, cfg.attn.n_heads, cfg.attn.n_kv_heads,
              cfg.attn.d_head, cfg.vocab_size, cfg.first_dense_mlp.d_ff,
              cfg.moe.e, cfg.moe.d_expert, cfg.moe.top_k, cfg.moe.n_shared,
              cfg.moe.router_scale_norm, cfg.n_layers)
    if widths != (2048, 16, 16, 128, 102400, 10944, 64, 1408, 6, 2, False,
                  28):
        raise AssertionError(f"deepseek-moe-16b widths changed: {widths}")
    binary = QuantPolicy.binary()
    prompts = mix_prompts(cfg.vocab_size)

    # full depth, packed only
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed, report, _ = lm.init_packed(
        torch.Generator(device=dev).manual_seed(SEED), cfg, binary)
    fp32_bytes, packed_bytes = report.bytes_fp32, report.bytes_after
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"serving MoE: {MOE_ARCH} full width, all {cfg.n_layers} layers, "
          f"built layer by layer in {time.perf_counter() - t0:.3f}s: fp32 "
          f"{fp32_bytes / 1e9:.3f} GB -> 1-bit packed {packed_bytes / 1e9:.3f}"
          f" GB; peak memory while building {build_peak:.3f} GB")
    ctx = QCtx(policy=binary, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend="vpu"))
    with torch.inference_mode():
        logits, _ = lm.prefill(packed, cfg, ctx, prefill_tokens(prompts, dev),
                               CACHE_LEN)
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"MoE: bad prefill logits {tuple(logits.shape)}")
    runs, launches = serve_mix(
        spec, cfg, binary, (("packed-vpu", packed, "vpu"),
                            ("packed-mxu", packed, "mxu")), prompts, "MoE ",
        ref_label="packed-vpu", profile=("packed-vpu", "packed-mxu"))
    gate_moe_launches(runs, launches, "",
                      cfg.n_layers - cfg.first_dense_layers, 1)
    if not same_streams(runs, "packed-mxu", "packed-vpu"):
        raise AssertionError("MoE full depth: packed-vpu and packed-mxu "
                             "greedy streams differ")
    print(f"serving MoE: {cfg.n_layers} layers, packed-vpu and packed-mxu "
          f"greedy streams identical; K7 {launches['packed-vpu']['xnor_mismatch_batched']}"
          f" and K8 {launches['packed-mxu']['xnor_dot_mxu_batched']} launches "
          f"= 3 x {cfg.n_layers - 1} MoE layers x (decode steps + prefills)")
    del packed, logits
    torch.cuda.empty_cache()

    # depth 4: the fake-quant oracle at full width
    cfg4 = dataclasses.replace(cfg, n_layers=MOE_CUT_DEPTH)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), cfg4)
    packed4, report = converter.convert(params, binary)
    print(f"serving MoE depth {MOE_CUT_DEPTH}: {report.summary()}")
    runs4, launches4 = serve_mix(
        spec, cfg4, binary, (("packed-vpu", packed4, "vpu"),
                             ("packed-mxu", packed4, "mxu"),
                             ("fake-quant", params, "vpu"),
                             ("packed-vpu-again", packed4, "vpu"),
                             ("packed-vpu-1-slot", packed4, "vpu", 1)),
        prompts, f"MoE depth {MOE_CUT_DEPTH} ", profile=())
    gate_moe_launches(runs4, launches4, f"depth {MOE_CUT_DEPTH} ",
                      MOE_CUT_DEPTH - cfg.first_dense_layers, 1)
    for label in ("packed-vpu", "packed-mxu", "packed-vpu-again"):
        if not same_streams(runs4, label, "fake-quant"):
            raise AssertionError(f"§2.2.2 violated (MoE depth "
                                 f"{MOE_CUT_DEPTH}): {label} != fake-quant")
    agree, total, first = stream_agreement(
        runs4["packed-vpu-1-slot"]["results"], runs4["packed-vpu"]["results"])
    per_request = dict(tokens_agree=agree, tokens=total,
                       first_difference=first)
    print(f"serving MoE depth {MOE_CUT_DEPTH}: greedy streams identical for "
          f"packed-vpu, packed-mxu, fake-quant and a repeated packed-vpu run "
          f"(§2.2.2; deterministic routing and combine); one slot at a time "
          f"vs 4 slots (reported, not gated): {per_request}")
    del params, packed4
    torch.cuda.empty_cache()
    main_launches = {
        "xnor_mismatch_batched": launches["packed-vpu"]["xnor_mismatch_batched"],
        "xnor_dot_mxu_batched": launches["packed-mxu"]["xnor_dot_mxu_batched"]}
    summary = {f"{tag}{k}": {kk: vv for kk, vv in v.items()
                             if kk != "results"}
               for tag, rs in (("full depth ", runs),
                               (f"depth {MOE_CUT_DEPTH} ", runs4))
               for k, v in rs.items()}
    summary.update(model_fp32_gb=fp32_bytes / 1e9,
                   model_packed_gb=packed_bytes / 1e9,
                   build_peak_memory_gb=build_peak,
                   per_request_vs_batched=per_request,
                   launches={"full depth": launches,
                             f"depth {MOE_CUT_DEPTH}": launches4})
    return main_launches, summary


def gate_moe_launches(runs, launches, tag: str, n_moe: int, bits: int):
    """The MoE cells' launch gates: the expert-batched kernel of each
    packed run's family (K7 / K8 at 1 bit, K9 / K10 at k bits) launches
    3 x MoE layers x (decode steps + prefill calls) times and the other
    batched kernels never; the width's prologue (K1 / K4) runs on every
    packed run, and the other width's prologue never; fake-quant launches
    nothing."""
    prologue, other = (("pack_sign", "quant_pack_planes") if bits == 1
                       else ("quant_pack_planes", "pack_sign"))
    batched = MOE_BATCHED[bits]
    absent = [k for b, ks in MOE_BATCHED.items() if b != bits
              for k in ks.values()] + [other]
    for label, ls in launches.items():
        fam = "xla" if label.startswith("fake") else label.split("-")[1]
        calls = 3 * n_moe * (runs[label]["steps"] + runs[label]["prefills"])
        want = {k: calls if fam == f else 0 for f, k in batched.items()}
        got = {k: ls[k] for k in want}
        packed = label.startswith("packed")
        if (got != want or (ls[prologue] > 0) != packed
                or any(ls[k] for k in absent)
                or (not packed and any(ls.values()))):
            raise AssertionError(f"MoE {tag}{label}: launches {ls}, "
                                 f"expected {want}")


def same_streams(runs, a: str, b: str) -> bool:
    return all(np.array_equal(runs[a]["results"][r], runs[b]["results"][r])
               for r in runs[b]["results"])


def serving_moe_kbit(dev) -> tuple[dict, dict]:
    """The MoE w4a4 cell: deepseek-moe-16b at full width (as
    :func:`serving_moe`), DoReFa ``QuantPolicy.quantized(4)``, float32
    compute, the granite request mix on 4 slots of a 256-row contiguous
    cache.  Runs, each with its kernel counts set to 0 just before it:

    - all 28 layers, built layer by layer (7.5 GB of expert planes),
      packed ``vpu`` (-> ``vpu-k4``: K4, K5 on attention / shared experts /
      layer 0, K9 on the routed experts) and ``mxu`` (-> ``mxu-k4``: K4,
      K6, K10): their greedy streams must be identical (the same integer
      S, the same dequant);
    - depth 4 (layer 0 + 3 MoE layers): packed ``vpu``, ``mxu`` (identical
      streams, gated) and fake-quant, whose agreement with the packed
      streams is reported, not gated (the k-bit contract is fp32-allclose
      per GEMM);
    - layer 1's up / gate / down grouped GEMMs on the routed rows of one
      fake-quant prefill: packed ``vpu`` and ``mxu`` against the fake-quant
      ``ragged_dot`` outputs within ``rtol=1e-4, atol=2e-4``.

    Launch gates (:func:`gate_moe_launches`): K9 == 3 x MoE layers x
    (decode steps + prefills) on the ``vpu`` runs and 0 elsewhere, K10
    likewise on ``mxu``, K4 on every packed run, K5 on ``vpu`` and K6 on
    ``mxu`` only, nothing on fake-quant.  Returns (K9 / K10 launches of the
    full-depth runs, summary)."""
    import dataclasses

    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.launch.serve import stream_agreement
    from repro_torch.models import lm, registry
    from repro_torch.nn.common import QCtx

    spec = registry.get(MOE_ARCH)
    cfg = spec.config
    w4a4 = QuantPolicy.quantized(4)
    prompts = mix_prompts(cfg.vocab_size)

    def gate(runs, launches, tag, n_layers):
        gate_moe_launches(runs, launches, tag,
                          n_layers - cfg.first_dense_layers, 4)
        for label, ls in launches.items():
            fam = label.split("-")[1] if label.startswith("packed") else None
            dense = {"vpu": ("kbit_plane_gemm", "kbit_mxu_gemm"),
                     "mxu": ("kbit_mxu_gemm", "kbit_plane_gemm")}.get(fam)
            if dense and not (ls[dense[0]] > 0 and ls[dense[1]] == 0):
                raise AssertionError(f"MoE w4a4 {tag}{label}: dense k-bit "
                                     f"launches {ls}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed, report, _ = lm.init_packed(
        torch.Generator(device=dev).manual_seed(SEED), cfg, w4a4)
    fp32_bytes, packed_bytes = report.bytes_fp32, report.bytes_after
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    expert_gb = 4 * sum(
        w.numel() for layer in packed["layers"] if "moe" in layer
        for w in layer["moe"]["experts"].values()) / 1e9
    print(f"serving MoE w4a4: {MOE_ARCH} full width, all {cfg.n_layers} "
          f"layers, built layer by layer in {build_s:.3f}s: fp32 "
          f"{fp32_bytes / 1e9:.3f} GB -> w4a4 packed {packed_bytes / 1e9:.3f} "
          f"GB ({expert_gb:.3f} GB of expert planes); peak memory while "
          f"building {build_peak:.3f} GB")
    ctx = QCtx(policy=w4a4, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend="vpu"))
    with torch.inference_mode():
        logits, _ = lm.prefill(packed, cfg, ctx, prefill_tokens(prompts, dev),
                               CACHE_LEN)
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"MoE w4a4: bad prefill logits "
                             f"{tuple(logits.shape)}")
    runs, launches = serve_mix(
        spec, cfg, w4a4, (("packed-vpu", packed, "vpu"),
                          ("packed-mxu", packed, "mxu")), prompts,
        "MoE w4a4 ", ref_label="packed-vpu",
        profile=("packed-vpu", "packed-mxu"))
    gate(runs, launches, "", cfg.n_layers)
    if not same_streams(runs, "packed-mxu", "packed-vpu"):
        raise AssertionError("MoE w4a4 full depth: packed-vpu and packed-mxu "
                             "greedy streams differ")
    print(f"serving MoE w4a4: {cfg.n_layers} layers, packed-vpu and "
          f"packed-mxu greedy streams identical; K9 "
          f"{launches['packed-vpu']['kbit_plane_gemm_batched']} and K10 "
          f"{launches['packed-mxu']['kbit_mxu_gemm_batched']} launches = 3 x "
          f"{cfg.n_layers - cfg.first_dense_layers} MoE layers x (decode "
          f"steps + prefills)")
    del packed, logits
    torch.cuda.empty_cache()

    # depth 4: the fake-quant oracle at full width
    cfg4 = dataclasses.replace(cfg, n_layers=MOE_CUT_DEPTH)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), cfg4)
    packed4, report = converter.convert(params, w4a4)
    print(f"serving MoE w4a4 depth {MOE_CUT_DEPTH}: {report.summary()}")
    layer1 = moe_layer1_gemms(cfg4, params, packed4, prompts, dev)
    runs4, launches4 = serve_mix(
        spec, cfg4, w4a4, (("packed-vpu", packed4, "vpu"),
                           ("packed-mxu", packed4, "mxu"),
                           ("fake-quant", params, "vpu")), prompts,
        f"MoE w4a4 depth {MOE_CUT_DEPTH} ", ref_label="packed-vpu",
        profile=())
    gate(runs4, launches4, f"depth {MOE_CUT_DEPTH} ", MOE_CUT_DEPTH)
    if not same_streams(runs4, "packed-mxu", "packed-vpu"):
        raise AssertionError(f"MoE w4a4 depth {MOE_CUT_DEPTH}: packed-vpu and "
                             "packed-mxu greedy streams differ")
    agreement = {}
    for label in ("packed-vpu", "packed-mxu"):
        agree, total, first = stream_agreement(
            runs4[label]["results"], runs4["fake-quant"]["results"])
        agreement[label] = dict(tokens_agree=agree, tokens=total,
                                first_difference=first)
    print(f"serving MoE w4a4 depth {MOE_CUT_DEPTH}: packed-vpu and packed-mxu "
          f"greedy streams identical; against fake-quant (measured, not "
          f"gated): {agreement}")
    del params, packed4
    torch.cuda.empty_cache()
    main_launches = {
        "kbit_plane_gemm_batched":
            launches["packed-vpu"]["kbit_plane_gemm_batched"],
        "kbit_mxu_gemm_batched":
            launches["packed-mxu"]["kbit_mxu_gemm_batched"]}
    summary = {f"{tag}{k}": {kk: vv for kk, vv in v.items()
                             if kk != "results"}
               for tag, rs in (("full depth ", runs),
                               (f"depth {MOE_CUT_DEPTH} ", runs4))
               for k, v in rs.items()}
    summary.update(model_fp32_gb=fp32_bytes / 1e9,
                   model_packed_gb=packed_bytes / 1e9,
                   expert_planes_gb=expert_gb, build_seconds=build_s,
                   build_peak_memory_gb=build_peak,
                   agreement_with_fake_quant=agreement,
                   layer1_packed_vs_fake_quant=layer1,
                   launches={"full depth": launches,
                             f"depth {MOE_CUT_DEPTH}": launches4})
    return main_launches, summary


def moe_layer1_gemms(cfg, params, packed, prompts, dev) -> dict:
    """Layer 1's (the first MoE layer's) up / gate / down grouped GEMMs on
    the routed rows of one fake-quant prefill (the mix's longest prompt):
    the inputs and outputs of the fake-quant ``ragged_dot`` calls are
    recorded, and packed ``quant_gemm_grouped`` (``vpu`` -> K9, ``mxu`` ->
    K10) on the converted layer-1 stacks must give the same outputs within
    ``rtol=1e-4, atol=2e-4``."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.models import lm
    from repro_torch.nn.common import QCtx

    seen = []
    ragged = dispatch.ragged_dot

    def recording(x, w, group_sizes):
        y = ragged(x, w, group_sizes)
        if len(seen) < 3:  # layer 0 is dense: the first three are layer 1's
            seen.append((x.clone(), group_sizes.clone(), y.clone()))
        return y

    ctx = QCtx(policy=QuantPolicy.quantized(4), compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend="vpu"))
    dispatch.ragged_dot = recording
    try:
        with torch.inference_mode():
            lm.prefill(params, cfg, ctx, prefill_tokens(prompts, dev),
                       CACHE_LEN)
    finally:
        dispatch.ragged_dot = ragged
    experts = packed["layers"][1]["moe"]["experts"]
    names = ("up", "gate", "down")
    d, f = cfg.d_model, cfg.moe.d_expert
    if len(seen) != 3 or [x.shape[1] for x, _, _ in seen] != [d, d, f]:
        raise AssertionError(f"layer 1 grouped GEMMs seen: "
                             f"{[tuple(x.shape) for x, _, _ in seen]}")
    out = {}
    for (x, gs, want), name in zip(seen, names):
        for backend in ("vpu", "mxu"):
            with torch.inference_mode():
                got = dispatch.quant_gemm_grouped(
                    x, experts[f"{name}_packed"], gs, k_true=x.shape[1],
                    config=GemmConfig(backend=backend), w_bits=4, a_bits=4)
            diff = (got - want).abs()
            limit = KBIT_TOL["atol"] + KBIT_TOL["rtol"] * want.abs()
            key = f"{name} {backend}"
            out[key] = dict(max_abs_err=float(diff.max()),
                            worst_over_limit=float((diff / limit).max()),
                            rows=int(x.shape[0]),
                            experts_used=int((gs > 0).sum()))
            if not bool((diff <= limit).all()):
                raise AssertionError(f"layer 1 {key}: packed != fake-quant "
                                     f"within {KBIT_TOL}: {out[key]}")
    worst = max(v["worst_over_limit"] for v in out.values())
    print(f"layer 1 (MoE) w4a4: {len(out)} packed grouped GEMM outputs (up/"
          f"gate/down x vpu/mxu, {seen[0][0].shape[0]} routed rows of a "
          f"{max(PROMPT_LENS)}-token prefill over "
          f"{out['up vpu']['experts_used']} experts) within {KBIT_TOL} of "
          f"fake-quant ragged_dot; largest |err| / limit {worst:.4f}; max "
          f"|err| {max(v['max_abs_err'] for v in out.values()):.3e}")
    return out


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
    prompts = mix_prompts(cfg.vocab_size)

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
    t0 = time.perf_counter()
    k11_launches, paged = serving_paged(spec, cfg, packed, dev)
    print(f"serving: paged cell {time.perf_counter() - t0:.3f}s")

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
                     "kbit_mxu_gemm": launches4["packed-mxu"]["kbit_mxu_gemm"],
                     "flash_decode": k11_launches}
    summary = {tag + k: {kk: vv for kk, vv in v.items() if kk != "results"}
               for tag, rs in (("", runs), ("w4a4 ", runs4))
               for k, v in rs.items()}
    summary["w4a4 agreement with fake-quant"] = agreement
    summary["layer0 packed vs fake-quant"] = layer0
    summary["paged cell"] = paged
    # what the speculative phase cuts and serves again
    state = dict(spec=spec, cfg=cfg, params=params, packed=packed,
                 packed4=packed4, prompts=prompts)
    return main_launches, summary, state


SPEC_RUNS = (  # label, target, backend, spec_len, draft, target-only run
    ("spec-vpu", "binary", "vpu", 2, "w1a1", "packed-vpu"),
    ("spec-mxu", "binary", "mxu", 2, "w1a1", "packed-mxu"),
    ("spec-w4a4-mxu", "w4a4", "mxu", 2, "w1a1", "w4a4 packed-mxu"),
    ("spec-paged-fused", "binary", "vpu", 4, "w1a1", "paged-fused"),
    ("spec-paged-fused-kv8", "binary", "vpu", 4, "w1a1", "paged-fused-kv8"),
    ("spec-self", "binary", "vpu", 3, "target", "packed-vpu"),
)
# the prologue and GEMM kernels each packed layer launches once per GEMM
SPEC_KERNELS = {("binary", "vpu"): ("pack_sign", "xnor_mismatch"),
                ("binary", "mxu"): ("pack_sign", "xnor_dot_mxu"),
                ("w4a4", "mxu"): ("quant_pack_planes", "kbit_mxu_gemm")}


def speculative(dev, served: dict) -> dict:
    """Phase 5b: speculative decoding on full-width granite-3-2b cut to
    its first ``SPEC_DEPTH`` of 40 layers (the serving phase's params cut;
    the script's time limit).  The target-only runs come first at that
    depth: the granite mix packed 1-bit ``vpu`` and ``mxu`` (streams
    identical) and w4a4 ``mxu``, and the paged cell's mix fused at fp and
    int8 KV, each under :func:`dense_launch_gate`.  The draft is the cut
    float params' leading ``SPEC_DRAFT_LAYERS`` layers packed to w1a1
    (``converter.derive_draft``); it runs its own contiguous fp cache, with
    the target's ``GemmConfig`` (so K1 + K2 under ``vpu``, K1 + K3 under
    ``mxu``).  Runs (``SPEC_RUNS``): contiguous 1-bit ``vpu`` and ``mxu``
    at spec_len 2 on the granite mix, w4a4 ``mxu`` (K4 + K6) with the w1a1
    draft, the paged cell's mix at spec_len 4 fused at fp and int8 KV (K11
    verifies 5-row windows), and the target as its own draft at spec_len 3.
    Each run's kernel counts are set to 0 just before it and read just
    after.  Gates: every stream equals its target-only stream; the
    target-as-draft acceptance is exactly 1.0 with
    fewer verify rounds than target-only decode steps; each packed GEMM
    kernel and its prologue launch 7 times per packed layer per forward
    call (target prefills and verify windows, draft prefills, restart
    windows and steps), K11 once per target layer per prefill window and per
    verify position on the fused runs (the verify attends position by
    position at the decode step's shapes, so its rows round as target-only
    decoding does), and nothing else packed runs; and at full width the
    verify window's logits equal the decode steps' bit for bit
    (:func:`window_bits`).  Reports tokens/s, rounds, acceptance, and one
    round's wall and device time by kernel (a round at the end of a full
    cache) beside the target-only decode step's."""
    import dataclasses

    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.launch.serve import stream_agreement
    from repro_torch.nn.common import QCtx
    from repro_torch.serve.engine import (DraftModel, Engine, EngineConfig,
                                          Request, Scheduler)

    spec, full = served["spec"], served["cfg"]
    cfg = dataclasses.replace(full, n_layers=SPEC_DEPTH)

    def cut(tree):
        return {**tree, "layers": tree["layers"][:SPEC_DEPTH]}

    binary, w4a4 = QuantPolicy.binary(), QuantPolicy.quantized(4)
    targets = {"binary": cut(served["packed"]), "w4a4": cut(served["packed4"])}
    t0 = time.perf_counter()
    dparams, dcfg, report = converter.derive_draft(
        cut(served["params"]), cfg, n_layers=SPEC_DRAFT_LAYERS, policy=binary)
    torch.cuda.synchronize()
    print(f"speculative: target {cfg.n_layers} of {full.n_layers} layers; "
          f"draft {dcfg.n_layers} layers, w1a1, {report.summary()}, cut and "
          f"packed in {time.perf_counter() - t0:.3f}s")
    tag = f"depth {SPEC_DEPTH} "
    runs1, _ = dense_mix(spec, cfg, binary, (
        ("packed-vpu", targets["binary"], "vpu"),
        ("packed-mxu", targets["binary"], "mxu")), served["prompts"], tag,
        profile=("packed-vpu",))
    runs4, _ = dense_mix(spec, cfg, w4a4, (
        ("packed-mxu", targets["w4a4"], "mxu"),), served["prompts"],
        tag + "w4a4 ", bits=4)
    paged_prompts_, paged_runs, engines = dense_paged(
        spec, cfg, targets["binary"], ("paged-fused", "paged-fused-kv8"), tag)
    paged_profile = profile_decode(engines.pop("paged-fused"),
                                   f"{tag}paged cell paged-fused")
    del engines
    target_only = {**runs1, **{"w4a4 " + k: v for k, v in runs4.items()},
                   **paged_runs}
    paged_cfg = dict(kv_block_size=PAGED_BLOCK, prefill_chunk=PAGED_CHUNK,
                     shared_prefix=True, fused_attn=True)
    runs = {}
    for label, quant, backend, s_len, draft_kind, ref_label in SPEC_RUNS:
        policy = binary if quant == "binary" else w4a4
        params = targets[quant]
        ctx = QCtx(policy=policy, compute_dtype=torch.float32,
                   gemm_config=GemmConfig(backend=backend))
        if draft_kind == "target":
            draft = DraftModel(cfg=cfg, params=params, ctx=ctx)
        else:
            draft = DraftModel(cfg=dcfg, params=dparams,
                               ctx=dataclasses.replace(ctx, policy=binary))
        paged = label.startswith("spec-paged")
        extra = dict(paged_cfg, kv_bits=8 if label.endswith("kv8") else None,
                     cache_len=PAGED_CACHE_LEN,
                     max_new_tokens=PAGED_NEW_TOKENS) if paged else dict(
            cache_len=CACHE_LEN, max_new_tokens=NEW_TOKENS)
        prompts = paged_prompts_ if paged else served["prompts"]
        eng = Engine(spec, cfg, ctx, params, EngineConfig(
            batch=DECODE_M, draft=draft, spec_len=s_len, **extra))
        sched = Scheduler(eng)
        for pr in prompts:
            sched.submit(Request(prompt=pr))
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t1 = time.perf_counter()
        results = sched.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches = dict(_cuda.LAUNCHES)
        st = sched.stats
        n_tok = sum(len(v) for v in results.values())
        ref = target_only[ref_label]
        where = f"speculative {label}"
        if sorted(results) != sorted(ref["results"]) or any(
                not np.array_equal(results[rid], ref["results"][rid])
                for rid in ref["results"]):
            same, total, first = stream_agreement(results, ref["results"])
            raise AssertionError(
                f"{where}: streams differ from the target-only {ref_label} "
                f"streams ({same} of {total} tokens agree, first difference "
                f"at {first})")
        # forward calls: the target's prefills (contiguous admission groups
        # or paged chunk windows) and verify rounds; the draft's prefills
        # (one per admission group, or per request once its prompt is in
        # the paged cache), restart windows and single steps
        t_calls = st.prefills + st.steps
        d_calls = (len(prompts) if paged else st.prefills) + st.steps * s_len
        d_layers = dcfg.n_layers if draft_kind == "w1a1" else cfg.n_layers
        want = {}
        t_kern = SPEC_KERNELS[(quant, backend)]
        d_kern = SPEC_KERNELS[("binary", backend)]
        for name in t_kern:
            want[name] = want.get(name, 0) + 7 * cfg.n_layers * t_calls
        for name in d_kern:
            want[name] = want.get(name, 0) + 7 * d_layers * d_calls
        if paged:  # the verify attends one position per call
            want["flash_decode"] = cfg.n_layers * (st.prefills
                                                   + st.steps * (s_len + 1))
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            raise AssertionError(f"{where}: launches {got}, expected {want} "
                                 f"(target calls {t_calls}, draft calls "
                                 f"{d_calls})")
        if paged and sched.alloc.live_blocks != 0:
            raise AssertionError(f"{where}: {sched.alloc.live_blocks} blocks "
                                 "still live after the run")
        if draft_kind == "target" and not (
                st.acceptance_rate == 1.0 and st.steps < ref["steps"]):
            raise AssertionError(
                f"{where}: acceptance {st.acceptance_rate} (must be 1.0), "
                f"{st.steps} verify rounds against {ref['steps']} target-only "
                f"decode steps")
        runs[label] = dict(
            seconds=dt, tokens=n_tok, tok_s=n_tok / dt,
            target_only_tok_s=ref["tok_s"], rounds=st.steps,
            target_only_steps=ref["steps"], slot_rounds=st.spec_rounds,
            proposed=st.spec_proposed, accepted=st.spec_accepted,
            acceptance=st.acceptance_rate, prefills=st.prefills,
            spec_len=s_len, launches=got)
        print(f"serving {where}: {n_tok} tokens in {dt:.4f}s = "
              f"{n_tok / dt:.3f} tok/s (target-only {ref_label} "
              f"{ref['tok_s']:.3f}); {st.steps} verify rounds (target-only "
              f"{ref['steps']} decode steps), {st.spec_rounds} slot rounds, "
              f"acceptance {st.acceptance_rate:.4f} ({st.spec_accepted}/"
              f"{st.spec_proposed}); streams == target-only; launches {got} "
              f"(= 7 x ({cfg.n_layers} x {t_calls} target + {d_layers} x {d_calls} draft "
              f"calls))")
        if label == "spec-vpu":
            runs[label]["window_bits"] = window_bits(eng, served["prompts"])
        if label in ("spec-vpu", "spec-paged-fused"):
            step = paged_profile if paged else ref["decode_profile"]
            runs[label]["round_profile"] = profile_spec_round(eng, where)
            runs[label]["target_only_step_profile"] = step
            print(f"profile {where}: against the target-only decode step "
                  f"at depth {SPEC_DEPTH}, wall {step['wall_ms_per_step']:.4f}"
                  f" ms, device {step['device_ms_per_step']} ms")
        del eng, sched
    print("speculative: every stream equals its target-only stream; "
          "draft == target accepts every proposal")
    return runs


def window_bits(eng, prompts) -> dict:
    """What exactness needs, at full width: after one prefill of the first
    ``DECODE_M`` prompts (cut to 16 tokens), ``spec_len + 1`` greedy decode
    steps give each position's logits; the verify window over the same
    tokens (``decode_window(logits_all=True)``, one position at a time at
    the decode step's shapes) must give the same bits at every position
    (gated).  Reported beside it, on seeded random inputs at the window's
    shapes (B rows x C positions): how many output elements of each fp32
    op that the verify runs per position change their bits when the op
    runs once over all B*C rows: RMSNorm over d_model (layer 0's weight),
    the tied-logits product and gather attention over the serving cache."""
    from repro_torch.models import lm
    from repro_torch.nn import attention
    from repro_torch.nn.common import norm_apply

    b, c = DECODE_M, eng.ecfg.spec_len + 1
    dev, cfg = eng.device, eng.cfg
    tokens = torch.as_tensor(np.stack([p[:16] for p in prompts[:b]]),
                             dtype=torch.long, device=dev)
    pos = torch.full((b,), 16, dtype=torch.int32, device=dev)

    def fresh(sub):
        cache = eng.init_cache()
        lm.cache_insert(cache, sub, torch.arange(b, device=dev), eng.kv)
        return cache

    def per_position(fn, *xs):
        return torch.cat([fn(*(x[:, j:j + 1].contiguous() for x in xs))
                          for j in range(c)], dim=1)

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    acfg = cfg.attn
    x = torch.randn((b, c, cfg.d_model), generator=gen, device=dev)
    q = torch.randn((b, c, acfg.n_kv_heads, acfg.groups, acfg.d_head),
                    generator=gen, device=dev)
    k, v = (torch.randn((b, CACHE_LEN, acfg.n_kv_heads, acfg.d_head),
                        generator=gen, device=dev) for _ in range(2))
    k_pos = torch.arange(CACHE_LEN, dtype=torch.int32, device=dev).expand(
        b, CACHE_LEN)
    q_pos = (torch.randint(c, CACHE_LEN - c, (b, 1), generator=gen,
                           device=dev) + torch.arange(c, device=dev)).to(
        torch.int32)
    ops = {
        "rmsnorm": lambda x_: norm_apply(
            cfg.norm, eng.params["layers"][0]["pre_norm"], x_),
        "tied logits": lambda x_: torch.einsum(
            "bsd,vd->bsv", x_, eng.params["embed"]["table"]),
        "gather attention": lambda q_, p_: attention._sdpa(
            acfg, q_, k, v, attention._mask(acfg, p_, k_pos)),
    }
    with torch.inference_mode():
        logits, sub = eng._prefill(tokens)
        cache = fresh(sub)
        win, steps = [], []
        tok = torch.argmax(logits[:, -1], -1)
        for j in range(c):
            win.append(tok)
            step, cache = eng._decode(cache, tok[:, None], pos + j)
            steps.append(step)
            tok = torch.argmax(step[:, -1], -1)
        win = torch.stack(win, 1)
        steps = torch.cat(steps, 1)
        verify, _ = eng._verify(fresh(sub), win, pos,
                                torch.ones((b,), dtype=torch.bool, device=dev))
        differ = {}
        for name, fn in ops.items():
            args = (q, q_pos) if name == "gather attention" else (x,)
            one, per = fn(*args), per_position(fn, *args)
            differ[name] = [int((one != per).sum()), one.numel()]
    out = dict(positions=c, verify_equals_decode=bool(torch.equal(verify,
                                                                  steps)),
               verify_max_abs_diff=float((verify - steps).abs().max()),
               one_pass_elements_that_differ=differ)
    print(f"speculative window bits ({b} rows x {c} positions after a "
          f"16-token prefill): verify == decode steps bit for bit "
          f"{out['verify_equals_decode']} (max |diff| "
          f"{out['verify_max_abs_diff']:.3e}); run once over all {b * c} rows "
          f"instead of per position, these ops change the bits of [elements, "
          f"of] (reported): {differ}")
    if not out["verify_equals_decode"]:
        raise AssertionError(f"verify window logits differ from the decode "
                             f"steps': {out}")
    return out


def profile_spec_round(eng, label: str, rounds: int = 3) -> dict:
    """Where one speculative round's time goes: the draft's restart window
    and spec_len - 1 steps, the target's verify window and the rollback of
    both caches, as ``Scheduler._spec_round`` runs them, for the batch at
    the end of a full cache (every row attended); wall time of ``rounds``
    rounds, then their device time by kernel under ``torch.profiler``.  The
    busy share is device time over unprofiled wall time."""
    b, s_len = eng.ecfg.batch, eng.ecfg.spec_len
    dev = eng.device
    cache = full_cache(eng)
    dcache = eng.d_init_cache()
    for lc in dcache["layers"]:
        lc["slot_pos"].copy_(torch.arange(eng.ecfg.cache_len, device=dev))
    p0 = eng.ecfg.cache_len - s_len - 2
    pos = torch.full((b,), p0, dtype=torch.int32, device=dev)
    dm = torch.ones((b,), dtype=torch.bool, device=dev)
    tok2 = torch.zeros((b, 2), dtype=torch.long, device=dev)

    def one_round():
        d_logits, _ = eng._d_window(dcache, tok2, pos - 1, dm)
        cur = eng._sample(d_logits, None, None, dm)
        props = [cur]
        for j in range(1, s_len):
            d_logits, _ = eng._d_step(dcache, cur.long()[:, None], pos + j, dm)
            cur = eng._sample(d_logits, None, None, dm)
            props.append(cur)
        props = torch.stack(props, 1).long()
        win = torch.cat([tok2[:, 1:], props], 1)
        logits, _ = eng._verify(cache, win, pos, dm)
        picks = torch.cat([props, torch.argmax(logits, -1)], 1).cpu()
        lengths = pos + 1
        eng._truncate(cache, lengths)
        eng._d_truncate(dcache, lengths)
        return picks

    with torch.inference_mode():
        for _ in range(2):
            one_round()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            one_round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
        by_name, _ = device_time_by_kernel(one_round, rounds)
    us = {k: ms * 1e3 for k, (ms, _) in by_name.items()}
    device_ms = sum(us.values()) / 1e3
    groups = {tag: sum(v for k, v in us.items() if sub in k)
              for tag, sub in (("K1", "pack_sign"), ("K2", "xnor_mismatch"),
                               ("K3", "xnor_dot_mxu"), ("K11", "flash_decode"))}
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms_per_round": wall_ms,
           "device_ms_per_round": device_ms if us else None,
           "device_busy_share": device_ms / wall_ms if us else None,
           "kernel_us_per_round": groups if us else None,
           "top_kernels_us_per_round": [[k[:90], v] for k, v in top]}
    if not us:
        print(f"profile {label} round: wall {wall_ms:.4f} ms/round; device "
              "time not measured (the profiler recorded no device events)")
    else:
        print(f"profile {label} round (spec_len {s_len}, batch {b} at "
              f"position {p0}): wall {wall_ms:.4f} ms/round, device "
              f"{device_ms:.4f} ms/round, busy share {device_ms / wall_ms:.4f}; "
              + ", ".join(f"{k} {v:.1f}us" for k, v in groups.items())
              + "; top: " + "; ".join(f"{k[:60]} {v:.1f}us" for k, v in top))
    return out


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


def paged_prompts(vocab: int) -> list:
    """The paged cell's requests: a common 512-token prefix (the shared
    system prompt) plus a unique tail of 64-448 tokens each."""
    rng = np.random.default_rng(SEED + 3)
    prefix = rng.integers(0, vocab, (PREFIX_LEN,))
    return [np.concatenate([prefix, rng.integers(
        0, vocab, (int(rng.integers(TAIL_LENS[0], TAIL_LENS[1] + 1)),))]
        ).astype(np.int32) for _ in range(PAGED_REQUESTS)]


PAGED_RUNS = (  # label, EngineConfig fields beyond the base
    ("contig-gather", {}),
    ("paged-gather", dict(kv_block_size=PAGED_BLOCK, prefill_chunk=PAGED_CHUNK,
                          shared_prefix=True)),
    ("paged-fused", dict(kv_block_size=PAGED_BLOCK, prefill_chunk=PAGED_CHUNK,
                         shared_prefix=True, fused_attn=True)),
    ("paged-fused-kv8", dict(kv_block_size=PAGED_BLOCK,
                             prefill_chunk=PAGED_CHUNK, shared_prefix=True,
                             fused_attn=True, kv_bits=8)),
    ("paged-fused-kv1", dict(kv_block_size=PAGED_BLOCK,
                             prefill_chunk=PAGED_CHUNK, shared_prefix=True,
                             fused_attn=True, kv_bits=1)),
    ("contig-fused", dict(fused_attn=True)),
)


def serving_paged(spec, cfg, packed, dev) -> tuple[int, dict]:
    """The paged cell: 1-bit packed ``vpu`` granite-3-2b, all layers, 8
    requests (``paged_prompts``, 32 new tokens each) on 4 slots of a
    2,048-row cache, served six ways (``PAGED_RUNS``, each through
    :func:`serve_paged` and its gates).
    Then layer 0's fused attention is held against the gather oracle at
    every pool tier (:func:`layer0_attention`).  Stream agreements between
    runs are reported, not gated.  Returns (K11 launches on the
    ``paged-fused`` run, summary)."""
    from repro_torch.launch.serve import stream_agreement

    prompts = paged_prompts(cfg.vocab_size)
    runs, engines = {}, {}
    for label, extra in PAGED_RUNS:
        runs[label], engines[label], _ = serve_paged(spec, cfg, packed,
                                                     prompts, label, extra)

    def agree(a, b):
        same, total, first = stream_agreement(runs[a]["results"],
                                              runs[b]["results"])
        return dict(tokens_agree=same, tokens=total, first_difference=first)

    agreement = {
        "paged-gather vs contig-gather": agree("paged-gather", "contig-gather"),
        "paged-fused vs paged-gather": agree("paged-fused", "paged-gather"),
        "contig-fused vs contig-gather": agree("contig-fused", "contig-gather"),
        "paged-fused-kv8 vs paged-fused": agree("paged-fused-kv8", "paged-fused"),
        "paged-fused-kv1 vs paged-fused": agree("paged-fused-kv1", "paged-fused"),
    }
    print(f"serving paged cell: stream agreement (reported, not gated): "
          f"{agreement}")
    oracle = {label: layer0_attention(engines[label], prompts)
              for label in ("paged-fused", "paged-fused-kv8", "paged-fused-kv1",
                            "contig-fused")}
    profiles = {label: profile_decode(engines[label], f"paged cell {label}")
                for label in ("paged-fused", "contig-gather")}
    summary = {label: {k: v for k, v in r.items() if k != "results"}
               for label, r in runs.items()}
    summary.update(agreement=agreement, layer0_fused_vs_oracle=oracle,
                   decode_profiles=profiles, prompt_lens=[len(p) for p in prompts])
    return runs["paged-fused"]["launches"]["flash_decode"], summary


def serve_paged(spec, cfg, packed, prompts, label: str, extra: dict,
                tag: str = ""):
    """One run of the paged cell's mix (``prompts``, ``PAGED_NEW_TOKENS``
    each) on 4 slots of a ``PAGED_CACHE_LEN``-row cache under 1-bit packed
    ``vpu``, ``extra`` the EngineConfig fields beyond that (a
    ``PAGED_RUNS`` entry), with the kernel counts set to 0 just before it
    and read just after.  Gates: every stream complete and in the
    vocabulary; on the paged layout the allocator ends with no live block
    and ``prefill_tokens + shared_tokens`` is the prompt tokens with
    ``shared_tokens > 0``; :func:`dense_launch_gate`: K1 and K2 launch 7 x
    layers x (decode steps + prefill calls) times, K11 layers x (decode
    steps + prefill windows) on fused runs (contiguous prefill is not a
    window) and 0 on gather runs, and nothing else.  Returns (the run's
    numbers and streams, its engine, its launches)."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.nn.common import QCtx
    from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                          Scheduler)

    ctx = QCtx(policy=QuantPolicy.binary(), compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend="vpu"))
    total_prompt = sum(len(p) for p in prompts)
    eng = Engine(spec, cfg, ctx, packed, EngineConfig(
        batch=DECODE_M, cache_len=PAGED_CACHE_LEN,
        max_new_tokens=PAGED_NEW_TOKENS, **extra))
    sched = Scheduler(eng)
    for pr in prompts:
        sched.submit(Request(prompt=pr))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    results = sched.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    st = sched.stats
    n_tok = sum(len(v) for v in results.values())
    windows = st.prefills if eng.paged else 0
    run = dict(
        results=results, seconds=dt, tokens=n_tok, tok_s=n_tok / dt,
        decode_ms_step=statistics.median(st.tpots()) * 1e3,
        steps=st.steps, prefills=st.prefills, prefill_windows=windows,
        prefill_tokens=st.prefill_tokens, shared_tokens=st.shared_tokens,
        launches={k: v for k, v in launches.items() if v})
    print(f"serving {tag}paged cell {label}: {n_tok} tokens in {dt:.4f}s = "
          f"{n_tok / dt:.3f} tok/s; decode {run['decode_ms_step']:.4f}"
          f" ms/step (median inter-token gap); {st.steps} decode steps, "
          f"{st.prefills} prefills ({windows} windows), prefill tokens "
          f"{st.prefill_tokens}, shared {st.shared_tokens}; launches "
          f"{run['launches']}")
    where = f"{tag}paged cell {label}"
    if sorted(results) != list(range(len(prompts))) or any(
            len(v) != PAGED_NEW_TOKENS or not ((v >= 0) & (v < cfg.vocab_size)).all()
            for v in results.values()):
        raise AssertionError(f"{where}: bad streams {results}")
    if eng.paged:
        if sched.alloc.live_blocks != 0:
            raise AssertionError(f"{where}: {sched.alloc.live_blocks} "
                                 "blocks still live after the run")
        if (st.prefill_tokens + st.shared_tokens != total_prompt
                or st.shared_tokens <= 0):
            raise AssertionError(
                f"{where}: prefill {st.prefill_tokens} + shared "
                f"{st.shared_tokens} != {total_prompt} prompt tokens")
    k11 = cfg.n_layers * (st.steps + windows) if extra.get("fused_attn") else 0
    dense_launch_gate(where, launches, cfg.n_layers, st.steps + st.prefills,
                      "vpu", k11=k11)
    return run, eng, launches


def layer0_attention(eng, prompts) -> dict:
    """Serve the first four requests (4 new tokens each) with every call of
    layer 0's fused attention also computed by the gather + ``_sdpa`` oracle
    over the same storage.  The gate is the first-order rounding bound of
    softmax attention, per output channel: key j's score differs between
    the two paths by at most ``ds_j = 2 (Dh + 1) 2^-24 sm_scale sum_d |q_d
    k_jd|`` (an fp32 dot product and its scaling, in two orders), which
    moves output channel d by at most ``sum_j p_j ds_j |v_jd - o_d|``.  That
    is bounded by the smaller of ``sum_j p_j ds_j (|v_jd| + |o_d|)`` and
    ``max_j ds_j * 4 (1 - p_max) max|v|`` (zero for a one-key softmax, the
    common row of a 1-bit model's large scores), plus ``2e-5 * max(1,
    max|v|)`` for the exponentials and value sums.  Rows that see no key are
    not compared.  Reports, over the checked channels, the median and max of
    the bound beside the median |output|, and on how many checked rows
    dropping the row's most probable key would move the output past the
    bound (what a kernel that loses a key would have to get past)."""
    import dataclasses

    from repro_torch.serve.engine import Request, Scheduler

    if eng.cfg.attn.logit_softcap is not None:
        raise AssertionError("layer0_attention's bound assumes no softcap")
    n_layers, base = eng.cfg.n_layers, eng.kv
    state = dict(calls=0, checked=0, rows=0, max_err=0.0, max_ratio=0.0,
                 drop_caught=0)
    bounds, outs = [], []

    class Layer0Check(type(base)):
        def attend(self, cache, q, q_pos, cfg):
            out = super().attend(cache, q, q_pos, cfg)
            if state["calls"] % n_layers == 0:
                check_attention(self, cache, q, q_pos, cfg, out, state,
                                bounds, outs)
            state["calls"] += 1
            return out

    eng.kv = Layer0Check(**dataclasses.asdict(base))
    try:
        sched = Scheduler(eng)
        for pr in prompts[:DECODE_M]:
            sched.submit(Request(prompt=pr, max_new_tokens=4))
        sched.run()
    finally:
        eng.kv = base
    bound, out = torch.cat(bounds), torch.cat(outs)
    state.update(bound_median=float(bound.median()), bound_max=float(bound.max()),
                 out_abs_median=float(out.median()))
    print(f"layer 0 fused vs gather oracle ({type(base).__name__}, kv_bits "
          f"{base.kv_bits}): {state['checked']} calls, {state['rows']} rows, "
          f"max |err| {state['max_err']:.3e}, max |err| / bound "
          f"{state['max_ratio']:.4f}; bound median {state['bound_median']:.3e}"
          f" max {state['bound_max']:.3e} against median |out| "
          f"{state['out_abs_median']:.3e}; a dropped top key would exceed the "
          f"bound on {state['drop_caught']} of {state['rows']} rows")
    return {k: v for k, v in state.items() if k != "calls"}


def check_attention(kv, cache, q, q_pos, cfg, out, state, bounds,
                    outs) -> None:
    """One fused call against the gather oracle (see layer0_attention)."""
    from repro_torch.nn import attention

    k, v, kpos = kv.gather(cache)
    mask = attention._mask(cfg, q_pos, kpos)  # (B, C, L)
    want = attention._sdpa(cfg, q.float(), k, v, mask)  # (B, C, KVH, G, Dh)
    qf, kf, m5 = q.float(), k.float(), mask[:, None, None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * cfg.scale
    p = torch.softmax(torch.where(m5, s, attention.NEG_INF), dim=-1)
    del s
    p_max, top = p.max(-1)  # (B, KVH, G, C)
    ds = torch.einsum("bqhgd,bkhd->bhgqk", qf.abs(), kf.abs()) * (
        2 * (cfg.d_head + 1) * 2.0 ** -24 * cfg.scale)
    pds = p * torch.where(m5, ds, 0.0)
    ds_max = torch.where(m5, ds, 0.0).amax(-1)
    del ds
    vabs = torch.where((kpos >= 0)[:, :, None, None], v.abs(), 0.0)
    vm = vabs.amax(dim=(1, 2, 3))[:, None, None, None, None]  # (B, 1, 1, 1, 1)

    def rows_last(x):  # (B, KVH, G, C) -> (B, C, KVH, G, 1)
        return x.permute(0, 3, 1, 2)[..., None]

    spread = rows_last(ds_max * 4 * (1 - p_max)) * vm
    per_key = (torch.einsum("bhgqk,bkhd->bqhgd", pds, vabs)
               + rows_last(pds.sum(-1)) * want.abs())
    del pds
    bound = torch.minimum(spread, per_key) + ATTN_TOL * vm.clamp(min=1.0)
    vis = mask.any(-1)  # (B, C)
    err = (out - want).abs()
    if vis.any():
        # dropping the most probable key t moves the output by
        # p_t (o - v_t) / (1 - p_t), or by -o when t is the only key
        b, h, g, c = top.shape
        v_top = torch.gather(v.float().permute(0, 2, 1, 3), 2,
                             top.reshape(b, h, g * c, 1).expand(
                                 -1, -1, -1, v.shape[-1]))
        v_top = v_top.view(b, h, g, c, -1).permute(0, 3, 1, 2, 4)
        pt = rows_last(p_max)
        drop = torch.where(pt < 1, pt * (want - v_top) / (1 - pt).clamp(
            min=1e-30), -want).abs()
        caught = (drop > bound).flatten(2).any(-1)  # (B, C)
        state["drop_caught"] += int(caught[vis].sum())
        bounds.append(bound[vis].flatten())
        outs.append(want.abs()[vis].flatten())
    ratio = float((err / bound)[vis].max()) if vis.any() else 0.0
    state["checked"] += 1
    state["rows"] += int(vis.sum())
    state["max_err"] = max(state["max_err"], float(err[vis].max()) if vis.any() else 0.0)
    state["max_ratio"] = max(state["max_ratio"], ratio)
    if ratio > 1.0 or not torch.isfinite(out[vis]).all():
        raise AssertionError(f"layer 0 fused attention off the gather oracle: "
                             f"{state}")


def full_cache(eng):
    """A serving cache whose every slot holds ``cache_len`` written
    positions (zero K/V) — each slot mapped onto its own blocks when paged
    — so that a decode step attends every row of the cache."""
    cache = eng.init_cache()
    b, length = eng.ecfg.batch, eng.ecfg.cache_len
    for lc in cache["layers"]:
        if eng.paged:
            nb, bs = lc["pool_pos"].shape
            lc["table"].copy_(torch.arange(nb, device=eng.device).view(b, -1))
            lc["pool_pos"].copy_(
                (torch.arange(nb * bs, device=eng.device) % length).view(nb, bs))
        else:
            lc["slot_pos"].copy_(torch.arange(length, device=eng.device))
    return cache


def device_time_by_kernel(fn, reps: int = 1):
    """Run ``fn()`` ``reps`` times under ``torch.profiler``.  Returns
    ({kernel name: (device ms, launches) per run}, the last run's result);
    the dict is empty when the profiler recorded no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            ms, n = by_name.get(evt.key, (0.0, 0.0))
            by_name[evt.key] = (
                ms + getattr(evt, "self_device_time_total", 0.0) / 1e3 / reps,
                n + evt.count / reps)
    return by_name, out


def profile_decode(eng, label: str, steps: int = 3) -> dict:
    """Where one decode step's time goes: wall time of ``steps`` plain
    decode steps (the batch at the last position of a full cache, so every
    cache row is attended), and the device time of the same steps under
    ``torch.profiler`` (kernels only, by name).  The device busy share is
    device time over unprofiled wall time."""
    b = eng.ecfg.batch
    tok = torch.zeros((b, 1), dtype=torch.long, device=eng.device)
    pos = torch.full((b,), eng.ecfg.cache_len - 1, dtype=torch.int32,
                     device=eng.device)
    cache = full_cache(eng)
    with torch.inference_mode():
        for _ in range(2):
            eng._decode(cache, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._decode(cache, tok, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name, _ = device_time_by_kernel(
            lambda: eng._decode(cache, tok, pos), steps)
    by_name = {k: ms * 1e3 for k, (ms, _) in by_name.items()}  # us
    device_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # every kernel of csrc/flash_decode.cu (K11: decode tile, split
    # combine, window tile) carries "flash_decode" in its name, and the
    # prologues' kernels (K1, K4) their sources' names
    us = {tag: sum(v for k, v in by_name.items() if sub in k)
          for tag, sub in (("k11", "flash_decode"), ("k1", "pack_sign"),
                           ("k4", "quant_pack_planes"))}
    out = {"wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms if by_name else None,
           "device_busy_share": device_ms / wall_ms if by_name else None,
           **{f"{tag}_us_per_step": v if by_name else None
              for tag, v in us.items()},
           "top_kernels_us_per_step": [[k[:90], v] for k, v in top]}
    if not by_name:
        print(f"profile {label}: wall {wall_ms:.4f} ms/step; device time "
              "not measured (the profiler recorded no device events)")
    else:
        print(f"profile {label}: wall {wall_ms:.4f} ms/step, device "
              f"{device_ms:.4f} ms/step, busy share {device_ms / wall_ms:.4f}, "
              f"K11 {us['k11']:.1f}us, K1 {us['k1']:.1f}us, K4 "
              f"{us['k4']:.1f}us; top: "
              + "; ".join(f"{k[:60]} {v:.1f}us" for k, v in top))
    return out


# --------------------------------------------------------------------------
# the dense phase: deepseek-7b and qwen2-72b at full width
# --------------------------------------------------------------------------


def dense_launch_gate(where: str, ls: dict, n_layers: int, calls: int,
                      backend: str | None, bits: int = 1, k11: int = 0):
    """The launch gate of a dense (not MoE) model's run: on a packed run
    the prologue (K1, or
    K4 at w4a4) and the backend's GEMM (K2 / K3, or K5 / K6) each launch
    7 x layers x ``calls`` times (decode steps + prefill calls, a paged
    run's windows among them), K11 ``k11`` times, and no other kernel
    launches; a fake-quant run (``backend`` None) launches nothing."""
    want = {"flash_decode": k11}
    if backend is not None:
        pro, gemm = {(1, "vpu"): ("pack_sign", "xnor_mismatch"),
                     (1, "mxu"): ("pack_sign", "xnor_dot_mxu"),
                     (4, "vpu"): ("quant_pack_planes", "kbit_plane_gemm"),
                     (4, "mxu"): ("quant_pack_planes", "kbit_mxu_gemm")}[
                         bits, backend]
        want.update({pro: 7 * n_layers * calls, gemm: 7 * n_layers * calls})
    want = {k: v for k, v in want.items() if v}
    got = {k: v for k, v in ls.items() if v}
    if got != want:
        raise AssertionError(f"{where}: launches {got}, expected {want}")


def dense_mix(spec, cfg, policy, runs_spec, prompts, tag: str, bits: int = 1,
              profile=(), cache_len: int = CACHE_LEN):
    """:func:`serve_mix` for a dense cell: every run's greedy streams must
    equal the first run's, and each run passes :func:`dense_launch_gate`
    (labels starting ``fake`` are fake-quant).  Returns (runs, launches)."""
    labels = [r[0] for r in runs_spec]
    runs, launches = serve_mix(spec, cfg, policy, runs_spec, prompts, tag,
                               ref_label=labels[0], profile=profile,
                               cache_len=cache_len)
    for label, _, backend, *_ in runs_spec:
        r = runs[label]
        dense_launch_gate(f"{tag}{label}", launches[label], cfg.n_layers,
                          r["steps"] + r["prefills"],
                          None if label.startswith("fake") else backend, bits)
        if not same_streams(runs, label, labels[0]):
            raise AssertionError(f"{tag}{label}: greedy streams differ from "
                                 f"{labels[0]}'s")
    print(f"serving {tag.rstrip()}: greedy streams identical for "
          f"{', '.join(labels)}; "
          f"launches = 7 x {cfg.n_layers} layers x (decode steps + prefills)")
    return runs, launches


def dense_paged(spec, cfg, packed, labels, tag: str):
    """The paged cell's mix (:func:`paged_prompts`) on a dense model,
    1-bit packed ``vpu``, one run per ``PAGED_RUNS`` label in ``labels``
    through :func:`serve_paged` and its gates.  Returns (prompts, runs,
    engines) by label."""
    prompts = paged_prompts(cfg.vocab_size)
    extra = dict(PAGED_RUNS)
    runs, engines = {}, {}
    for label in labels:
        runs[label], engines[label], _ = serve_paged(
            spec, cfg, packed, prompts, label, extra[label], tag)
    return prompts, runs, engines


def dense_check_widths(cfg, want: tuple) -> None:
    widths = (cfg.n_layers, cfg.d_model, cfg.attn.n_heads, cfg.attn.n_kv_heads,
              cfg.attn.d_head, cfg.mlp.d_ff, cfg.vocab_size, cfg.attn.qkv_bias,
              cfg.attn.rope_theta, cfg.tie_embeddings)
    if widths != want:
        raise AssertionError(f"{cfg.name} widths changed: {widths}")


def strip(runs: dict) -> dict:
    return {k: {kk: vv for kk, vv in v.items() if kk != "results"}
            for k, v in runs.items()}


def serving_deepseek_7b(dev) -> dict:
    """deepseek-7b at full width (d_model 4096, 32 heads of 128 over 32
    kv-heads: MHA, G 1; d_ff 11008; vocab 102400, untied head), all 30
    layers, seeded params built whole in fp32 (27.6 GB, so fake-quant runs
    at full depth), float32 compute.  Runs, each with its kernel counts
    set to 0 just before it:

    - the granite mix, 1-bit: packed ``vpu`` (K1 + K2), packed ``mxu``
      (K1 + K3) and fake-quant, streams identical (§2.2.2);
    - the paged cell's mix, 1-bit ``vpu``: contiguous gather, paged gather
      (whose streams must equal the contiguous run's) and paged fused at fp
      KV (K11 at G 1, Dh 128), whose layer-0 attention must stay within the
      gather oracle's bound (:func:`layer0_attention`);
    - the granite mix at w4a4: packed ``vpu`` (-> ``vpu-k4``: K4 + K5) and
      ``mxu`` (-> ``mxu-k4``: K4 + K6), streams identical.

    Every packed run passes :func:`dense_launch_gate`."""
    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import lm, registry

    spec = registry.get("deepseek-7b")
    cfg = spec.config
    dense_check_widths(cfg, (30, 4096, 32, 32, 128, 11008, 102400, False,
                             10000.0, False))
    binary, w4a4 = QuantPolicy.binary(), QuantPolicy.quantized(4)
    tag = "deepseek-7b "
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), cfg)
    packed, report = converter.convert(params, binary)
    torch.cuda.synchronize()
    print(f"serving {tag}full width, all {cfg.n_layers} layers; init + "
          f"convert {time.perf_counter() - t0:.3f}s; 1-bit {report.summary()}")
    prompts = mix_prompts(cfg.vocab_size)
    runs, launches = dense_mix(spec, cfg, binary, (
        ("packed-vpu", packed, "vpu"), ("packed-mxu", packed, "mxu"),
        ("fake-quant", params, "vpu")), prompts, tag,
        profile=("packed-vpu",))

    paged_p, paged, engines = dense_paged(
        spec, cfg, packed, ("contig-gather", "paged-gather", "paged-fused"),
        tag)
    if not same_streams(paged, "paged-gather", "contig-gather"):
        raise AssertionError(f"{tag}paged cell: paged-gather streams differ "
                             "from contig-gather's")
    oracle = layer0_attention(engines.pop("paged-fused"), paged_p)
    del engines
    print(f"serving {tag}paged cell: paged-gather streams == contig-gather; "
          f"K11 (G 1, Dh 128) launches = {cfg.n_layers} layers x (decode "
          f"steps + windows); layer 0 fused within the gather oracle's bound "
          f"(max |err| / bound {oracle['max_ratio']:.4f})")
    del packed
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    packed4, report4 = converter.convert(params, w4a4)
    torch.cuda.synchronize()
    print(f"serving {tag}w4a4 convert {time.perf_counter() - t0:.3f}s; "
          f"{report4.summary()}")
    del params
    runs4, launches4 = dense_mix(spec, cfg, w4a4, (
        ("packed-vpu", packed4, "vpu"), ("packed-mxu", packed4, "mxu")),
        prompts, tag + "w4a4 ", bits=4)
    del packed4
    torch.cuda.empty_cache()
    return dict(model_fp32_gb=report.bytes_fp32 / 1e9,
                model_packed_gb=report.bytes_after / 1e9,
                mix=strip(runs), paged=strip(paged), layer0_fused_vs_oracle=oracle,
                w4a4=strip(runs4),
                launches={"mix": launches, "w4a4": launches4,
                          "paged": {k: v["launches"] for k, v in paged.items()}})


def chunked_vs_sdpa(dev, acfg) -> dict:
    """``_sdpa_chunked`` against ``_sdpa`` at qwen2-72b's layer-0 attention
    shapes (64 query heads over 8 kv-heads of 128) and ``CHUNKED_SEQ``
    causal positions, on unit-normal q / k / v from the seed:
    ``_full_sdpa`` with ``full_attn_max_seq`` lowered below the length
    takes the chunked path (chunks of 512 queries x 1,024 keys).  Both fp32
    paths are held against softmax attention in float64 (one kv-head at a
    time) within ``ATTN_TOL`` and timed once each (CUDA events)."""
    import dataclasses

    from repro_torch.nn import attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    s, kvh, g, dh = CHUNKED_SEQ, acfg.n_kv_heads, acfg.groups, acfg.d_head
    q = torch.randn((1, s, kvh, g, dh), generator=gen, device=dev)
    k = torch.randn((1, s, kvh, dh), generator=gen, device=dev)
    v = torch.randn((1, s, kvh, dh), generator=gen, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    low = dataclasses.replace(acfg, full_attn_max_seq=s // 2)
    mask = attention._mask(acfg, pos, pos)
    with torch.inference_mode():
        chunked_ms = event_ms(lambda: attention._full_sdpa(
            low, q, k, v, pos, pos), {}, reps=1)
        sdpa_ms = event_ms(lambda: attention._sdpa(acfg, q, k, v, mask), {},
                           reps=1)
        chunked = attention._full_sdpa(low, q, k, v, pos, pos)
        full = attention._sdpa(acfg, q, k, v, mask)
        err = {"chunked": 0.0, "sdpa": 0.0}
        for h in range(kvh):
            sc = torch.einsum("qgd,kd->gqk", q[0, :, h].double(),
                              k[0, :, h].double()) * acfg.scale
            sc = sc.masked_fill(~mask[0], float("-inf"))
            ref = torch.einsum("gqk,kd->qgd", torch.softmax(sc, -1),
                               v[0, :, h].double())
            del sc
            for name, out in (("chunked", chunked), ("sdpa", full)):
                err[name] = max(err[name], float(
                    (out[0, :, h].double() - ref).abs().max()))
    out = dict(seq=s, kvh=kvh, g=g, dh=dh, chunk_q=low.chunk_q,
               chunk_kv=low.chunk_kv, max_abs_err_vs_float64=err,
               bound=ATTN_TOL, chunked_ms=chunked_ms, sdpa_ms=sdpa_ms,
               chunked_vs_sdpa=float((chunked - full).abs().max()))
    print(f"dense qwen2-72b _sdpa_chunked vs _sdpa ({s} causal positions, "
          f"KVH {kvh}, G {g}, Dh {dh}, chunks {low.chunk_q} x "
          f"{low.chunk_kv}): max |err| vs float64 chunked {err['chunked']:.3e}"
          f", _sdpa {err['sdpa']:.3e} (bound {ATTN_TOL}); chunked vs _sdpa "
          f"{out['chunked_vs_sdpa']:.3e}; {chunked_ms:.3f} ms chunked, "
          f"{sdpa_ms:.3f} ms _sdpa (one call each)")
    if not torch.isfinite(chunked).all() or max(err.values()) > ATTN_TOL:
        raise AssertionError(f"_sdpa_chunked off float64: {out}")
    return out


def serving_qwen2_72b(dev) -> dict:
    """qwen2-72b at full width (d_model 8192, 64 heads of 128 over 8
    kv-heads: G 8; QKV bias; rope_theta 1e6; d_ff 29568; vocab 152064,
    untied head), float32 compute, 1-bit.  First ``_sdpa_chunked`` against
    ``_sdpa`` (:func:`chunked_vs_sdpa`).  Then all 80 layers, built by
    ``lm.init_packed`` one fp32 layer at a time (72.7 B parameters, 290.8
    GB in fp32, never whole); gate: the build's peak memory above what was
    allocated before stays under the packed bytes plus two fp32 layers.
    Runs, each with its kernel counts set to 0 just before it:

    - the granite mix: packed ``vpu`` and ``mxu``, streams identical;
    - the paged cell's mix: paged gather and paged fused at fp KV (K11 at
      G 8, Dh 128; its prefill windows at C*G 2,048), the fused run's
      layer-0 attention within the gather oracle's bound;
    - one ``LONG_PROMPT``-token prompt, ``NEW_TOKENS`` new tokens, one slot
      of a ``LONG_CACHE_LEN``-row contiguous cache: its prefill takes
      ``_sdpa_chunked``; packed ``vpu`` and ``mxu``, streams identical;
    - depth ``DENSE_CUT_DEPTH`` at full width (about 24 GB of fp32
      weights): packed ``vpu``, packed ``mxu`` and fake-quant, streams
      identical on the granite mix and on the long prompt (§2.2.2).

    Every run passes :func:`dense_launch_gate`."""
    import dataclasses

    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import lm, registry

    spec = registry.get("qwen2-72b")
    cfg = spec.config
    dense_check_widths(cfg, (80, 8192, 64, 8, 128, 29568, 152064, True,
                             1_000_000.0, False))
    binary = QuantPolicy.binary()
    tag = "qwen2-72b "
    chunked = chunked_vs_sdpa(dev, cfg.attn)
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed, report, _ = lm.init_packed(
        torch.Generator(device=dev).manual_seed(SEED), cfg, binary)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() - before
    layer_fp32 = sum(l.bytes_fp32 for l in report.leaves
                     if l.path.startswith("layers/0/"))
    limit = report.bytes_after + 2 * layer_fp32
    print(f"serving {tag}full width, all {cfg.n_layers} layers, built by "
          f"lm.init_packed in {build_s:.3f}s: fp32 {report.bytes_fp32 / 1e9:.3f}"
          f" GB -> 1-bit packed {report.bytes_after / 1e9:.3f} GB; build peak "
          f"memory {build_peak / 1e9:.3f} GB (gate: packed + 2 fp32 layers = "
          f"{limit / 1e9:.3f} GB)")
    if build_peak > limit:
        raise AssertionError(f"{tag}build peak {build_peak} bytes > {limit}")
    prompts = mix_prompts(cfg.vocab_size)
    runs, launches = dense_mix(spec, cfg, binary, (
        ("packed-vpu", packed, "vpu"), ("packed-mxu", packed, "mxu")),
        prompts, tag, profile=("packed-vpu",))

    paged_p, paged, engines = dense_paged(
        spec, cfg, packed, ("paged-gather", "paged-fused"), tag)
    oracle = layer0_attention(engines["paged-fused"], paged_p)
    paged_profile = profile_decode(engines.pop("paged-fused"),
                                   f"{tag}paged cell paged-fused")
    del engines
    print(f"serving {tag}paged cell: K11 (G 8, Dh 128) launches = "
          f"{cfg.n_layers} layers x (decode steps + windows); layer 0 fused "
          f"within the gather oracle's bound (max |err| / bound "
          f"{oracle['max_ratio']:.4f})")

    long_p = [np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (LONG_PROMPT,)).astype(np.int32)]
    long_runs, long_launches = dense_mix(spec, cfg, binary, (
        ("packed-vpu", packed, "vpu", 1), ("packed-mxu", packed, "mxu", 1)),
        long_p, f"{tag}long prompt ", cache_len=LONG_CACHE_LEN)
    print(f"serving {tag}long prompt: {LONG_PROMPT}-token prefill (through "
          f"_sdpa_chunked) "
          + ", ".join(f"{k} {v['ttft_s']:.3f}s" for k, v in long_runs.items())
          + f" to the first token; peak memory "
          f"{max(v['peak_memory_gb'] for v in long_runs.values()):.3f} GB")
    del packed
    torch.cuda.empty_cache()

    cfg4 = dataclasses.replace(cfg, n_layers=DENSE_CUT_DEPTH)
    params4 = lm.init(torch.Generator(device=dev).manual_seed(SEED), cfg4)
    packed4, report4 = converter.convert(params4, binary)
    print(f"serving {tag}depth {DENSE_CUT_DEPTH}: {report4.summary()}")
    cut = f"{tag}depth {DENSE_CUT_DEPTH} "
    runs_spec = (("packed-vpu", packed4, "vpu"), ("packed-mxu", packed4, "mxu"),
                 ("fake-quant", params4, "vpu"))
    runs4, launches4 = dense_mix(spec, cfg4, binary, runs_spec, prompts, cut)
    long4, long_launches4 = dense_mix(
        spec, cfg4, binary, tuple(r + (1,) for r in runs_spec), long_p,
        f"{cut}long prompt ", cache_len=LONG_CACHE_LEN)
    del params4, packed4
    torch.cuda.empty_cache()
    return dict(model_fp32_gb=report.bytes_fp32 / 1e9,
                model_packed_gb=report.bytes_after / 1e9,
                build_s=build_s, build_peak_gb=build_peak / 1e9,
                build_gate_gb=limit / 1e9, chunked_vs_sdpa=chunked,
                mix=strip(runs), paged=strip(paged),
                paged_fused_profile=paged_profile,
                layer0_fused_vs_oracle=oracle, long_prompt=strip(long_runs),
                depth4=strip(runs4), depth4_long_prompt=strip(long4),
                launches={"mix": launches, "long": long_launches,
                          "paged": {k: v["launches"] for k, v in paged.items()},
                          "depth4": launches4, "depth4 long": long_launches4})


def dense_phase(dev) -> dict:
    """The dense llama / qwen family at full width on K1-K6 and K11
    (:func:`serving_deepseek_7b`, :func:`serving_qwen2_72b`)."""
    return {"deepseek-7b": serving_deepseek_7b(dev),
            "qwen2-72b": serving_qwen2_72b(dev)}


def cnn_model(arch: str):
    """(spec, init, forward) of one of the paper's CNNs."""
    from repro_torch.models import cnn, registry

    if arch == "lenet-mnist":
        return registry.get(arch), cnn.lenet_init, cnn.lenet_forward
    return registry.get(arch), cnn.resnet18_init, cnn.resnet18_forward


def cnn_ctx(policy, backend: str = "vpu", log: dict | None = None):
    """A float32 ``QCtx``; with ``log``, its ``conv`` and ``dense`` also
    keep each layer's kind, options and input under the layer's path."""
    from repro_torch.kernels.dispatch import GemmConfig
    from repro_torch.nn.common import QCtx

    class RecordingQCtx(QCtx):
        def conv(self, p, x, path, **kw):
            log[path] = ("conv", kw, x.detach().clone())
            return super().conv(p, x, path, **kw)

        def dense(self, p, x, path):
            log[path] = ("dense", {}, x.detach().clone())
            return super().dense(p, x, path)

    cls = QCtx if log is None else RecordingQCtx
    return cls(policy=policy, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=backend))


def binarized(x: torch.Tensor, spec) -> torch.Tensor:
    """What a quantized layer makes of its input: the sign at 1 bit, the
    DoReFa code at k bits."""
    if spec.a_bits == 1:
        return x >= 0
    return torch.round(x.clamp(0.0, 1.0) * (2**spec.a_bits - 1))


def boundary_distance(x: torch.Tensor, spec) -> torch.Tensor:
    if spec.a_bits == 1:
        return x.abs()
    u = x * (2**spec.a_bits - 1)
    return (u - torch.floor(u) - 0.5).abs() / (2**spec.a_bits - 1)


def differing_activations(policy, log_a: dict, log_b: dict) -> dict:
    """Per quantized layer, how many binarized activations two runs'
    inputs disagree on.  The first layer where any differ must see inputs
    within ``CNN_TIE_EPS`` of the boundary there (rounding, not a fault)."""
    out = {}
    for path, (_, _, a) in log_a.items():
        spec = policy.spec(path)
        if spec.is_fp:
            continue
        b = log_b[path][2].to(a.device)
        diff = binarized(a, spec) != binarized(b, spec)
        n = int(diff.sum())
        if n and not any(out.values()):
            dist = boundary_distance(a, spec)[diff].max().item()
            if dist > CNN_TIE_EPS:
                raise AssertionError(
                    f"{path}: {n} binarized activations differ, up to "
                    f"{dist:.3g} from the boundary (> {CNN_TIE_EPS})")
        out[path] = n
    return out


def cnn_launches(forward, params, cfg, ctx, x) -> tuple[torch.Tensor, dict]:
    """Logits of one forward and the kernel launches it made (counts set
    to 0 just before it and read just after)."""
    from repro_torch.kernels import _cuda

    _cuda.reset_launches()
    with torch.no_grad():
        y = forward(params, cfg, ctx, x)
    torch.cuda.synchronize()
    return y, {k: v for k, v in _cuda.LAUNCHES.items() if v}


CNN_PACKED = {  # policy -> backend -> (prologue, GEMM) kernels
    1: {"vpu": ("pack_sign", "xnor_mismatch"),
        "mxu": ("pack_sign", "xnor_dot_mxu")},
    4: {"vpu": ("quant_pack_planes", "kbit_plane_gemm"),
        "mxu": ("quant_pack_planes", "kbit_mxu_gemm")}}


def cnn_packed_runs(forward, params, packed, n_layers, cfg, policy, x,
                    tag: str) -> dict:
    """Packed ``vpu`` and ``mxu`` forwards, whose logits must be identical
    and whose launches must be one prologue and one GEMM per binarized
    layer; fake-quant launches no kernel.  Returns the logits by label."""
    out = {}
    fake, launched = cnn_launches(forward, params, cfg, cnn_ctx(policy), x)
    if launched:
        raise AssertionError(f"{tag}: fake-quant launched {launched}")
    out["fake-quant"] = fake
    for backend, names in CNN_PACKED[policy.w_bits].items():
        y, launched = cnn_launches(forward, packed, cfg,
                                   cnn_ctx(policy, backend), x)
        if launched != {k: n_layers for k in names}:
            raise AssertionError(f"{tag} packed-{backend}: launches "
                                 f"{launched}, expected {n_layers} of "
                                 f"each of {names}")
        if not torch.isfinite(y).all():
            raise AssertionError(f"{tag} packed-{backend}: non-finite logits")
        out[f"packed-{backend}"] = y
    if not torch.equal(out["packed-vpu"], out["packed-mxu"]):
        raise AssertionError(f"{tag}: packed-vpu != packed-mxu")
    if policy.w_bits == 1 and not torch.equal(out["packed-vpu"], fake):
        raise AssertionError(f"{tag}: packed != fake-quant (§2.2.2)")
    return out


def cnn_smoke(dev) -> dict:
    """Smoke LeNet / ResNet-18 from one seeded init on the CPU and on the
    card: logits card vs CPU (``CNN_CARD_ATOL``, module constants), and on
    each device packed ``vpu`` == ``mxu`` (== fake-quant at 1 bit)."""
    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.tree import tree_map

    policies = {"fp": QuantPolicy.full_precision(),
                "binary": QuantPolicy.binary(),
                "w4a4": QuantPolicy.quantized(4)}
    summary = {}
    for arch in CNN_ARCHS:
        spec, init, forward = cnn_model(arch)
        cfg = spec.smoke
        host = init(torch.Generator().manual_seed(SEED), cfg)
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (CNN_SMOKE_BATCH, cfg.in_hw, cfg.in_hw, cfg.in_c)).astype(
                np.float32))
        runs = {}
        for d in ("cpu", dev):
            params = tree_map(lambda t: t.to(d), host)
            for name, pol in policies.items():
                log = {}
                with torch.no_grad():
                    y = forward(params, cfg, cnn_ctx(pol, log=log), x.to(d))
                runs[(str(d), name)] = (y.cpu(), log)
                if name != "fp" and d != "cpu":
                    packed, rep = converter.convert(params, pol)
                    cnn_packed_runs(forward, params, packed, rep.n_packed,
                                    cfg, pol, x.to(d), f"{arch} smoke {name}")
        for name, pol in policies.items():
            (yc, logc), (yg, logg) = runs[("cpu", name)], runs[(str(dev),
                                                                 name)]
            flips = differing_activations(pol, logc, logg)
            err = (yg - yc).abs().max().item()
            n = sum(flips.values())
            print(f"cnn smoke {arch} {name}: logits card vs CPU max |err| "
                  f"{err:.3g}; {n} binarized activations differ"
                  + ("" if name == "fp" else "; packed-vpu == packed-mxu"
                     + (" == fake-quant" if name == "binary" else "")
                     + " on the card"))
            if n == 0 and err > CNN_CARD_ATOL:
                raise AssertionError(f"cnn smoke {arch} {name}: card vs CPU "
                                     f"{err} > {CNN_CARD_ATOL}")
            summary[f"{arch} {name}"] = {"logits_err": err,
                                         "differing_activations": n}
    return summary


def cnn_layer_errors(forward, params, packed, cfg, policy, x) -> float:
    """Every quantized layer, fed the input fake-quant gives it: packed
    (``vpu``) within the k-bit contract of fake-quant.  Returns the largest
    error."""
    log = {}
    with torch.no_grad():
        forward(params, cfg, cnn_ctx(policy, log=log), x)
    ctx = cnn_ctx(policy)
    worst = 0.0
    for path, (kind, kw, xin) in log.items():
        if policy.spec(path).is_fp:
            continue
        node_f, node_p = params, packed
        for seg in path.split("/"):
            node_f, node_p = node_f[seg], node_p[seg]
        fn = ctx.conv if kind == "conv" else ctx.dense
        with torch.no_grad():
            want, got = fn(node_f, xin, path, **kw), fn(node_p, xin, path, **kw)
        if not torch.allclose(got, want, **KBIT_TOL):
            raise AssertionError(f"{path}: packed w4a4 differs from "
                                 f"fake-quant beyond {KBIT_TOL}: max |err| "
                                 f"{(got - want).abs().max().item()}")
        worst = max(worst, (got - want).abs().max().item())
    return worst


def cnn_time(forward, params, cfg, ctx, x) -> float:
    """Median ms of one forward (``CNN_TIMING_REPS`` after one warm-up),
    host clock around a synchronised forward."""
    times = []
    with torch.no_grad():
        for i in range(CNN_TIMING_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(params, cfg, ctx, x)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cnn_full_width(dev) -> dict:
    """LeNet (batch 256) and ResNet-18 CIFAR (batch 128) at full width from
    seeded weights: 1-bit packed ``vpu`` == ``mxu`` == fake-quant; w4a4
    ``vpu-k4`` == ``mxu-k4`` and every layer within the k-bit contract of
    fake-quant (the whole model reported); launches gated; the forward
    timed per variant and the packed forwards profiled."""
    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy

    device = nvidia_smi("name,power.limit")
    binary, w4a4 = QuantPolicy.binary(), QuantPolicy.quantized(4)
    summary = {}
    for arch in CNN_ARCHS:
        spec, init, forward = cnn_model(arch)
        cfg = spec.config
        widths = ((cfg.c1, cfg.c2, cfg.fc1, cfg.in_hw, cfg.in_c)
                  if arch == "lenet-mnist"
                  else (cfg.widths, cfg.in_hw, cfg.in_c))
        if widths != CNN_WIDTHS[arch]:
            raise AssertionError(f"{arch} widths changed: {widths}")
        b = CNN_BATCH[arch]
        params = init(torch.Generator(device=dev).manual_seed(SEED), cfg)
        x = torch.randn((b, cfg.in_hw, cfg.in_hw, cfg.in_c), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 1))
        row = {"batch": b}
        variants = {"fp32": (params, cnn_ctx(QuantPolicy.full_precision()))}
        for tag, pol in (("1-bit", binary), ("w4a4", w4a4)):
            packed, rep = converter.convert(params, pol)
            out = cnn_packed_runs(forward, params, packed, rep.n_packed, cfg,
                                  pol, x, f"{arch} {tag}")
            fake = out["fake-quant"]
            agree = (out["packed-vpu"].argmax(-1)
                     == fake.argmax(-1)).sum().item()
            whole = (out["packed-vpu"] - fake).abs().max().item()
            line = (f"cnn {arch} full width, batch {b}, {tag}: "
                    f"{rep.n_packed} binarized layers; packed-vpu == "
                    f"packed-mxu")
            if pol.w_bits == 1:
                line += " == fake-quant (bit for bit)"
            else:
                row["w4a4 layer max |err|"] = cnn_layer_errors(
                    forward, params, packed, cfg, pol, x)
                line += (f"; every layer within {KBIT_TOL} of fake-quant "
                         f"(max |err| {row['w4a4 layer max |err|']:.3g}); "
                         f"whole model vs fake-quant max |err| {whole:.3g}, "
                         f"{agree} of {b} argmax agree (reported)")
            n_binarized = rep.n_packed
            print(line + f"; each packed run launched "
                  f"{CNN_PACKED[pol.w_bits]['vpu'][0]} and its GEMM "
                  f"{rep.n_packed} times; {rep.summary()}")
            row[f"{tag} whole-model |err| vs fake-quant"] = whole
            row[f"{tag} argmax agree"] = agree
            variants[f"fake-quant {tag}"] = (params, cnn_ctx(pol))
            for backend in ("vpu", "mxu"):
                variants[f"packed-{backend} {tag}"] = (packed,
                                                       cnn_ctx(pol, backend))
        times = {}
        for label, (p, ctx) in variants.items():
            times[label] = cnn_time(forward, p, cfg, ctx, x)
        row["forward_ms"] = times
        print(f"cnn timing {arch} full width, batch {b}, median forward ms "
              f"of {CNN_TIMING_REPS} ({device}): "
              + "; ".join(f"{k} {v:.3f}" for k, v in times.items()))
        profiles = {}
        for tag, bits in (("1-bit", 1), ("w4a4", 4)):
            for backend, names in CNN_PACKED[bits].items():
                label = f"packed-{backend} {tag}"
                p, ctx = variants[label]
                with torch.no_grad():
                    by_name, _ = device_time_by_kernel(
                        lambda: forward(p, cfg, ctx, x), CNN_PROFILE_REPS)
                top = sorted(([k[:90], ms, n] for k, (ms, n) in
                              by_name.items()), key=lambda r: -r[1])
                profiles[label] = top[:8]
                device_ms = sum(ms for ms, _ in by_name.values())
                ours = {}
                for name in names:  # its symbols carry the name less "_gemm"
                    hits = [v for k, v in by_name.items()
                            if name.removesuffix("_gemm") in k]
                    ours[name] = (sum(ms for ms, _ in hits),
                                  sum(n for _, n in hits))
                if not any(n for _, n in ours.values()):
                    raise AssertionError(f"{arch} {label}: the profile shows "
                                         f"none of {names}: {top[:8]}")
                profiles[label + " ms, launches"] = ours
                print(f"cnn profile {arch} {label} ({device}), per forward "
                      f"of {CNN_PROFILE_REPS}: device {device_ms:.3f} ms; "
                      + ", ".join(f"{k} {v:.3f} ms ({n:g} of {n_binarized} "
                                  "launches seen)"
                                  for k, (v, n) in ours.items())
                      + f" (largest {max(ours, key=lambda k: ours[k][0])}); "
                      "top: " + "; ".join(f"{k[:60]} {v:.3f}ms"
                                          for k, v, _ in top[:4]))
        row["profiles"] = profiles
        summary[arch] = row
        del params, variants
        torch.cuda.empty_cache()
    return summary


def cnn_trained(dev) -> dict:
    """``CNN_TRAIN_STEPS`` steps of full-width binary LeNet with the
    binary_mnist twin's step (batch 256, its AdamW settings), then the
    trained weights packed: ``vpu`` == ``mxu`` == fake-quant logits."""
    from repro_torch.core import converter
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch import binary_mnist
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    spec, init, forward = cnn_model("lenet-mnist")
    cfg = spec.config
    b = CNN_BATCH["lenet-mnist"]
    binary = QuantPolicy.binary()
    params = init(torch.Generator(device=dev).manual_seed(SEED), cfg)
    opt = adamw.init(params)
    step = trainer.make_classifier_step(
        forward, cfg, cnn_ctx(binary),
        adamw.AdamWConfig(lr=1e-2, warmup_steps=5,
                          total_steps=CNN_TRAIN_STEPS, weight_decay=0.0))
    rng = np.random.default_rng(SEED)
    losses = []
    t0 = time.perf_counter()
    for _ in range(CNN_TRAIN_STEPS):
        xb, yb = binary_mnist._data(rng, b, cfg.in_hw)
        params, opt, loss = step(params, opt, torch.from_numpy(xb).to(dev),
                                 torch.from_numpy(yb).to(dev))
        losses.append(loss.item())
    secs = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite LeNet training loss: {losses}")
    xt, yt = binary_mnist._data(np.random.default_rng(SEED + 1), b, cfg.in_hw)
    xt = torch.from_numpy(xt).to(dev)
    packed, rep = converter.convert(params, binary)
    out = cnn_packed_runs(forward, params, packed, rep.n_packed, cfg, binary,
                          xt, "trained lenet-mnist")
    acc = (out["fake-quant"].argmax(-1).cpu()
           == torch.from_numpy(yt)).to(torch.float32).mean().item()
    print(f"cnn trained lenet-mnist: {CNN_TRAIN_STEPS} full-width binary "
          f"steps of {b} images in {secs:.3f}s, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; test accuracy {acc:.4f}; packed-vpu == "
          f"packed-mxu == fake-quant on the trained weights (bit for bit)")
    return {"losses": losses, "seconds": secs, "accuracy": acc}


def cnn_phase(dev) -> dict:
    """Phase "cnn": the paper's binary CNNs (smoke card vs CPU, full width,
    trained)."""
    return {"smoke": cnn_smoke(dev), "full width": cnn_full_width(dev),
            "trained": cnn_trained(dev)}


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
    err["flash_decode"] = max(parity_attn(dev), parity_attn_verify(dev))
    err.update(parity_moe(dev))
    for name, e in parity_xnor(dev).items():
        err[name] = max(err[name], e)
    err.update(parity_moe_kbit(dev))
    print(f"parity phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    floor_ms = graph_node_floor_ms(dev)
    print(f"timing graph-node floor (a one-element zero_, 200 calls in one "
          f"CUDA graph): {floor_ms * 1e3:.3f} us")
    totals, rows = timing(dev, popc_per_s, floor_ms)
    k2_prefill = layer_total(rows, "xnor_mismatch", PREFILL_M)
    print_layer_total(f"timing K2 per granite decode layer (7 GEMMs, "
                      f"M={DECODE_M})", totals["xnor_mismatch"])
    print_layer_total(f"timing K2 per granite prefill layer (7 GEMMs, "
                      f"M={PREFILL_M}; library = bf16 torch.matmul)",
                      k2_prefill)
    prologue_layers = {}
    for kname, tag in (("pack_sign", "K1"), ("quant_pack_planes", "K4 w4a4")):
        for m in (DECODE_M, PREFILL_M):
            t = layer_total(rows, kname, m)
            prologue_layers[f"{kname} M={m}"] = t
            print_layer_total(f"timing {tag} per granite layer (7 calls, "
                              f"M={m})", t)
    prologue_rows = timing_prologues(dev, floor_ms)
    _, qwen_rows = timing(dev, popc_per_s, floor_ms, gemms=QWEN_LAYER_GEMMS,
                          families={1: ONE_BIT}, ms=(DECODE_M,),
                          model="qwen2-72b")
    qwen_layer = {}
    for kname, tag in (("pack_sign", "K1"), ("xnor_mismatch", "K2"),
                       ("xnor_dot_mxu", "K3")):
        qwen_layer[kname] = layer_total(qwen_rows, kname, DECODE_M)
        print_layer_total(f"timing {tag} per qwen2-72b decode layer (7 "
                          f"calls, M={DECODE_M})", qwen_layer[kname])
    moe_totals, moe_rows = timing_moe(dev, popc_per_s)
    totals.update(moe_totals)
    attn_rows = timing_attn(dev)
    # K11 at the dense models' heads (Dh 128): qwen2-72b's 8 kv-heads of
    # G 8 and deepseek-7b's 32 of G 1, fp32 pools, decode and a prefill
    # window
    dense_attn_rows = [
        r for kvh, g, model in ((8, 8, "qwen2-72b"), (32, 1, "deepseek-7b"))
        for r in timing_attn(dev, kvh=kvh, g=g, dh=128, cs=(1, PAGED_CHUNK),
                             tiers=("fp32",), full_cache_row=False,
                             model=model)]
    err["flash_decode"] = max(err["flash_decode"],
                              *(r["max_abs_err"] for r in attn_rows
                                + dense_attn_rows))
    decode = next(r for r in attn_rows if r["c"] == 1 and r["tier"] == "fp32"
                  and r["cache"] == "serving")
    totals["flash_decode"] = {k: decode[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    print(f"timing phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    train_summary = training(dev)
    print(f"training phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    launches, serve_summary, served = serving(dev)
    print(f"serving phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    serve_summary["speculative"] = speculative(dev, served)
    del served
    print(f"speculative phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    moe_launches, moe_summary = serving_moe(dev)
    launches.update(moe_launches)
    serve_summary["MoE cell"] = moe_summary
    print(f"MoE serving phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    kbit_launches, kbit_summary = serving_moe_kbit(dev)
    launches.update(kbit_launches)
    serve_summary["MoE w4a4 cell"] = kbit_summary
    print(f"MoE w4a4 serving phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    serve_summary["dense"] = dense_phase(dev)
    print(f"dense phase {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    cnn_summary = cnn_phase(dev)
    print(f"cnn phase {time.perf_counter() - t0:.3f}s")

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
        "moe_timing_rows": moe_rows, "attention_timing_rows": attn_rows,
        "qwen2-72b_timing_rows": qwen_rows,
        "qwen2-72b_decode_layer (K1-K3)": qwen_layer,
        "dense_attention_timing_rows": dense_attn_rows,
        "kernel_totals_decode_layer (K4-K6 at w4a4, K11 fp32 pool, K7/K8 "
        "and K9/K10 (w4a4) one MoE layer)": totals,
        "xnor_mismatch_prefill_layer": k2_prefill,
        "graph_node_floor_ms": floor_ms,
        "prologue_layers (K1, K4 w4a4)": prologue_layers,
        "prologue_timing_rows": prologue_rows,
        "training": train_summary,
        "serving": serve_summary,
        "cnn": cnn_summary,
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
