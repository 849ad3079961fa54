// Unpack-to-int8 binary GEMM on the tensor cores: (M, Kw) x (N, Kw) 32-bit
// words -> (M, N) int32 "padded" +-1 dot over exactly the Kw words given:
// every word is unpacked to 32 int8 lanes (bit 1 -> +1, bit 0 -> -1), so the
// zero K-tail bits of the last word unpack to (-1)(-1) = +1 and inflate the
// dot by Kw*32 - k_true, which dispatch subtracts
// (xnor_gemm.mxu_pad_inflation with the Kw passed here).
//
// The expert-batched form runs the same tile over a leading expert axis:
// (E, M, Kw) x (E, N, Kw) -> (E, M, N), one expert per blockIdx.z.
//
// Replaces: src/repro/kernels/xnor_gemm.py, xnor_dot_mxu_pallas
// (_mxu_kernel, _unpack_pm1_i8), the "mxu" backend (repro_xnor_dot_mxu);
// and xnor_dot_mxu_batched_pallas (_mxu_kernel_batched), the MoE expert
// buckets of the "mxu" backend (repro_xnor_dot_mxu_batched).
//
// Bound on the H100: at decode (M = batch <= 8) bytes — the packed weights
// are read once; at prefill M the int8 tensor cores (2*M*N*K ops).
// Design: a block owns a 16 x 64 output tile (4 warps, each two m16n8
// fragments) and loops over Kw itself in 8-word (256-lane) stages — no
// split-K, no atomics, deterministic int32 sums.  Each stage reads the
// packed words coalesced (one 32-byte sector per row) and unpacks them into
// +-1 int8 tiles in shared memory; the warps then contract the tiles with
// mma.sync.m16n8k32 s8 x s8 -> s32.  So device memory carries only the
// packed words (32x fewer bytes than int8), as on the TPU.  Words past Kw
// are never read: their shared-memory lanes are written as 0 (not -1), so
// the kernel contracts exactly Kw words whatever the tile size.  Rows are
// padded by 16 bytes so the fragment loads of a warp hit 32 distinct banks.
// The batched kernel offsets the operands and the output by its expert's
// strides; its pad inflation is that of the Kw it is given, as for the 2-D
// form.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 16;            // one m16 fragment row block
constexpr int kWarps = 4;
constexpr int kBN = kWarps * 16;   // each warp: two n8 fragments
constexpr int kBKW = 8;            // words per stage
constexpr int kBK = kBKW * 32;     // int8 lanes per row per stage
constexpr int kLds = kBK + 16;     // row stride in bytes (bank-conflict pad)
constexpr int kThreads = kWarps * 32;

// Four bits (LSB first) -> four int8 lanes: byte j = bit j ? +1 : -1.
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t nibble) {
  const uint32_t t = (nibble & 1u) | ((nibble & 2u) << 7) |
                     ((nibble & 4u) << 14) | ((nibble & 8u) << 21);
  return 0xFFFFFFFFu ^ (t * 0xFEu);  // 0x01 where the bit is set, 0xFF else
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16 x 64 output tile of one (M, Kw) x (N, Kw) product.
__device__ __forceinline__ void mxu_tile(const uint32_t* __restrict__ a,
                                         const uint32_t* __restrict__ b,
                                         int32_t* __restrict__ out,
                                         long long m, long long n,
                                         long long kw) {
  __shared__ __align__(16) int8_t sa[kBM][kLds];
  __shared__ __align__(16) int8_t sb[kBN][kLds];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  int acc[2][4] = {};

  for (long long w0 = 0; w0 < kw; w0 += kBKW) {
    // unpack (kBM + kBN) rows x kBKW words; row-major i keeps a row's 8
    // words (32 bytes) on neighbouring threads
    for (int i = tid; i < (kBM + kBN) * kBKW; i += kThreads) {
      const int r = i / kBKW, c = i % kBKW;
      const bool is_a = r < kBM;
      const int rr = is_a ? r : r - kBM;
      const long long gr = (is_a ? m0 : n0) + rr, gc = w0 + c;
      int8_t* row = is_a ? sa[rr] : sb[rr];
      uint4* dst = reinterpret_cast<uint4*>(row + c * 32);
      if (gc < kw && gr < (is_a ? m : n)) {
        const uint32_t w = (is_a ? a : b)[gr * kw + gc];
        dst[0] = make_uint4(pm1_bytes(w), pm1_bytes(w >> 4), pm1_bytes(w >> 8),
                            pm1_bytes(w >> 12));
        dst[1] = make_uint4(pm1_bytes(w >> 16), pm1_bytes(w >> 20),
                            pm1_bytes(w >> 24), pm1_bytes(w >> 28));
      } else {  // absent word: zero lanes contribute nothing
        dst[0] = make_uint4(0u, 0u, 0u, 0u);
        dst[1] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      // A fragment (16 x 32, row): regs 0/2 row g, regs 1/3 row g + 8;
      // regs 0/1 k = 4t..4t+3, regs 2/3 k = 16 + 4t..
      const uint32_t af[4] = {ld32(&sa[g][ks + 4 * t]),
                              ld32(&sa[g + 8][ks + 4 * t]),
                              ld32(&sa[g][ks + 16 + 4 * t]),
                              ld32(&sa[g + 8][ks + 16 + 4 * t])};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B fragment (32 x 8, col): column g, k = 4t.. and 16 + 4t..
        const int8_t* br = sb[warp * 16 + j * 8 + g];
        mma_s8(acc[j], af, ld32(br + ks + 4 * t), ld32(br + ks + 16 + 4 * t));
      }
    }
    __syncthreads();
  }
  // C fragment (16 x 8): regs 0/1 row g, regs 2/3 row g + 8; col 2t + (i & 1)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = m0 + g + (i >= 2 ? 8 : 0);
      const long long col = n0 + warp * 16 + j * 8 + 2 * t + (i & 1);
      if (row < m && col < n) out[row * n + col] = acc[j][i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
xnor_dot_mxu_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                    long long m, long long n, long long kw) {
  mxu_tile(a, b, out, m, n, kw);
}

// blockIdx.z = expert: its (M, Kw), (N, Kw) and (M, N) slabs.
__global__ void __launch_bounds__(kThreads)
xnor_dot_mxu_batched_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            int32_t* __restrict__ out, long long m,
                            long long n, long long kw) {
  const long long e = blockIdx.z;
  mxu_tile(a + e * m * kw, b + e * n * kw, out + e * m * n, m, n, kw);
}

}  // namespace

extern "C" int repro_xnor_dot_mxu(const int32_t* a, const int32_t* b,
                                  int32_t* out, long long m, long long n,
                                  long long kw, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM));
  xnor_dot_mxu_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
      out, m, n, kw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_xnor_dot_mxu_batched(const int32_t* a, const int32_t* b,
                                          int32_t* out, long long e,
                                          long long m, long long n,
                                          long long kw, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>(e));
  xnor_dot_mxu_batched_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
      out, m, n, kw);
  return static_cast<int>(cudaGetLastError());
}
