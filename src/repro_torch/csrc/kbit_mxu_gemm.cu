// k-bit GEMM on the tensor cores: (ka, M, Kw) x (kb, N, Kw) 32-bit plane
// words -> (M, N) int32 S = sum_k n_a[m, k] * n_w[n, k], the integer dot of
// the DoReFa codes n = sum_i 2^i * plane_i — the same S as
// kbit_plane_gemm.cu, bit for bit.
//
// Replaces: src/repro/kernels/kbit_mxu.py, kbit_mxu_gemm_pallas
// (_mxu_kbit_kernel, _unpack_codes_i8, _offset_dot, _restore_s), the
// mxu-k2/k4/k8 backends.
//
// Bound on the H100: at decode (M = batch <= 8) bytes — the kb weight planes
// are read once; at prefill M the int8 tensor cores (2*M*N*K ops).  Design:
// xnor_dot_mxu.cu's skeleton.  A block owns a 16 x 64 output tile (4 warps,
// each two m16n8 fragments) and loops over Kw itself in 8-word (256-lane)
// stages — no split-K, no atomics, deterministic int32 sums.  Each stage
// reads the plane words coalesced and reassembles one byte-wide code lane
// per bit position in shared memory (byte l = sum_i bit l of plane i << i),
// then the warps contract the byte tiles with mma.sync.m16n8k32 u8 x u8 ->
// s32.  Device memory carries only the plane words (k/8 of the int8 codes'
// bytes).  The TPU kernel contracts signed offset codes n - 2^(k-1) and
// restores S with a rank-1 binomial correction, because the TPU's int8
// matrix unit is signed; Hopper's mma takes unsigned 8-bit operands, so the
// codes 0..255 go in as they are and S comes out directly: no offset, no
// restore, no pad term.  Words past Kw and rows past M or N are written as
// code 0, which adds nothing.  One int32 partial per output accumulates the
// whole code dot, at most K*Na*Nw, which dispatch bounds by 2*K*Na*Nw < 2^31.
// Rows are padded by 16 bytes so the fragment loads of a warp hit 32 banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kBM = 16;            // one m16 fragment row block
constexpr int kWarps = 4;
constexpr int kBN = kWarps * 16;   // each warp: two n8 fragments
constexpr int kBKW = 8;            // words per stage
constexpr int kBK = kBKW * 32;     // code lanes per row per stage
constexpr int kLds = kBK + 16;     // row stride in bytes (bank-conflict pad)
constexpr int kThreads = kWarps * 32;

// Eight bits (LSB first) -> eight bytes, byte j = bit j (0 or 1).
__device__ __forceinline__ unsigned long long spread8(uint32_t byte) {
  const unsigned long long x =
      (static_cast<unsigned long long>(byte) * 0x0101010101010101ull) &
      0x8040201008040201ull;  // byte j keeps only bit j
  return ((x + 0x7F7F7F7F7F7F7F7Full) & 0x8080808080808080ull) >> 7;
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
kbit_mxu_gemm_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                     long long m, long long n, long long kw, int ka, int kb) {
  __shared__ __align__(16) uint8_t sa[kBM][kLds];
  __shared__ __align__(16) uint8_t sb[kBN][kLds];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  int acc[2][4] = {};

  for (long long w0 = 0; w0 < kw; w0 += kBKW) {
    // reassemble (kBM + kBN) rows x kBKW words; row-major i keeps a row's 8
    // words (32 bytes of each plane) on neighbouring threads
    for (int i = tid; i < (kBM + kBN) * kBKW; i += kThreads) {
      const int r = i / kBKW, c = i % kBKW;
      const bool is_a = r < kBM;
      const int rr = is_a ? r : r - kBM;
      const long long gr = (is_a ? m0 : n0) + rr, gc = w0 + c;
      uint8_t* row = is_a ? sa[rr] : sb[rr];
      uint4* dst = reinterpret_cast<uint4*>(row + c * 32);
      unsigned long long lanes[4] = {0ull, 0ull, 0ull, 0ull};  // 32 code bytes
      if (gc < kw && gr < (is_a ? m : n)) {
        const uint32_t* src = is_a ? a : b;
        const long long plane = is_a ? m * kw : n * kw;
        const int planes = is_a ? ka : kb;
        for (int p = 0; p < planes; ++p) {
          const uint32_t w = src[p * plane + gr * kw + gc];
#pragma unroll
          for (int q = 0; q < 4; ++q) lanes[q] |= spread8((w >> (8 * q)) & 0xFFu) << p;
        }
      }  // absent word or row: code 0 lanes contribute nothing
      dst[0] = make_uint4(static_cast<uint32_t>(lanes[0]),
                          static_cast<uint32_t>(lanes[0] >> 32),
                          static_cast<uint32_t>(lanes[1]),
                          static_cast<uint32_t>(lanes[1] >> 32));
      dst[1] = make_uint4(static_cast<uint32_t>(lanes[2]),
                          static_cast<uint32_t>(lanes[2] >> 32),
                          static_cast<uint32_t>(lanes[3]),
                          static_cast<uint32_t>(lanes[3] >> 32));
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
        const uint8_t* br = sb[warp * 16 + j * 8 + g];
        mma_u8(acc[j], af, ld32(br + ks + 4 * t), ld32(br + ks + 16 + 4 * t));
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

}  // namespace

extern "C" int repro_kbit_mxu_gemm(const int32_t* a, const int32_t* b,
                                   int32_t* out, long long m, long long n,
                                   long long kw, int ka, int kb,
                                   cudaStream_t stream) {
  if (ka < 1 || ka > kMaxPlanes || kb < 1 || kb > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM));
  kbit_mxu_gemm_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
      out, m, n, kw, ka, kb);
  return static_cast<int>(cudaGetLastError());
}
