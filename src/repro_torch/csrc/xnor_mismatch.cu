// xnor+popcount GEMM (BMXNet Listing 3): (M, Kw) x (N, Kw) 32-bit words ->
// (M, N) int32 mismatch counts  sum_w popc(a[i, w] ^ b[j, w]).  Dispatch
// forms the exact +-1 dot as k_true - 2 * mismatches.  The expert-batched
// form runs the same tile over a leading expert axis: (E, M, Kw) x
// (E, N, Kw) -> (E, M, N), one expert per blockIdx.z.
//
// Replaces: src/repro/kernels/xnor_gemm.py, xnor_mismatch_pallas
// (_vpu_kernel), the default "vpu" backend (repro_xnor_mismatch); and
// xnor_mismatch_batched_pallas (_vpu_kernel_batched), the MoE expert
// buckets of the "vpu" backend (repro_xnor_mismatch_batched).
//
// Bound on the H100: at decode (M = batch <= 8) bytes — the packed weights
// are read once and each weight word meets only M activation words; at
// prefill M the integer units (xor + popc + add per word pair).  Design: a
// block owns an 8 x 32 output tile (one output per thread: warp = row,
// lane = weight row) and loops over Kw itself in 32-word stages, so blocks
// share nothing and need no split-K or atomics: the integer sums are
// deterministic.  A stage stages 8 activation rows and 32 weight rows in
// shared memory; the weight rows are read coalesced along Kw (a warp reads
// one 128-byte row), which is what the decode case streams.  The weight
// tile carries one pad word per row so that 32 lanes reading 32 different
// rows at the same word hit 32 different banks; activation words are a
// broadcast.  Words past Kw are never read, and the K-tail bits inside the
// last word are 0 in both operands (core/bitpack.py), so they add no
// mismatch and no per-call correction exists.  The batched kernel offsets
// the operands and the output by its expert's strides and runs the same
// tile.  At decode (64 buckets of 24 rows) the function is bound by the
// bytes of the expert stacks; each expert's words are fetched by its three
// 8-row tiles, the second and third time mostly from L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 8;    // activation rows per block (one per warp)
constexpr int kBN = 32;   // weight rows per block (one per lane)
constexpr int kBKW = 32;  // words per shared-memory stage
constexpr int kThreads = kBM * kBN;

// One 8 x 32 output tile of one (M, Kw) x (N, Kw) product.
__device__ __forceinline__ void mismatch_tile(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    int32_t* __restrict__ out, long long m, long long n, long long kw) {
  __shared__ uint32_t sa[kBM][kBKW];
  __shared__ uint32_t sb[kBN][kBKW + 1];
  const int tid = threadIdx.x;
  const int tm = tid / kBN;
  const int tn = tid % kBN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  int acc = 0;
  for (long long w0 = 0; w0 < kw; w0 += kBKW) {
    {
      const int r = tid / kBKW, c = tid % kBKW;  // kBM * kBKW == kThreads
      const long long gr = m0 + r, gc = w0 + c;
      sa[r][c] = (gr < m && gc < kw) ? a[gr * kw + gc] : 0u;
    }
    for (int i = tid; i < kBN * kBKW; i += kThreads) {
      const int r = i / kBKW, c = i % kBKW;
      const long long gr = n0 + r, gc = w0 + c;
      sb[r][c] = (gr < n && gc < kw) ? b[gr * kw + gc] : 0u;
    }
    __syncthreads();
    const int words = static_cast<int>(kw - w0 < kBKW ? kw - w0 : kBKW);
    for (int c = 0; c < words; ++c) acc += __popc(sa[tm][c] ^ sb[tn][c]);
    __syncthreads();
  }
  const long long row = m0 + tm, col = n0 + tn;
  if (row < m && col < n) out[row * n + col] = acc;
}

__global__ void __launch_bounds__(kThreads)
xnor_mismatch_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                     long long m, long long n, long long kw) {
  mismatch_tile(a, b, out, m, n, kw);
}

// blockIdx.z = expert: its (M, Kw), (N, Kw) and (M, N) slabs.
__global__ void __launch_bounds__(kThreads)
xnor_mismatch_batched_kernel(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             int32_t* __restrict__ out, long long m,
                             long long n, long long kw) {
  const long long e = blockIdx.z;
  mismatch_tile(a + e * m * kw, b + e * n * kw, out + e * m * n, m, n, kw);
}

}  // namespace

extern "C" int repro_xnor_mismatch(const int32_t* a, const int32_t* b,
                                   int32_t* out, long long m, long long n,
                                   long long kw, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM));
  xnor_mismatch_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
      out, m, n, kw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_xnor_mismatch_batched(const int32_t* a, const int32_t* b,
                                           int32_t* out, long long e,
                                           long long m, long long n,
                                           long long kw, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>(e));
  xnor_mismatch_batched_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
      out, m, n, kw);
  return static_cast<int>(cudaGetLastError());
}
