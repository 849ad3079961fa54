// k-bit bit-plane GEMM (DoReFa codes split into bit planes, paper Eq. 1):
// (ka, M, Kw) x (kb, N, Kw) 32-bit plane words -> (M, N) int32
//   S[m, n] = sum_{i < ka, j < kb} 2^(i+j) * sum_w popc(A_i[m, w] & B_j[n, w]),
// the integer dot of the activation codes with the weight codes.  Dispatch
// forms the DoReFa dot as (2S - Nw*T) / (Na*Nw).
//
// Replaces: src/repro/kernels/kbit_gemm.py, kbit_plane_gemm_pallas
// (_kbit_kernel, _plane_popcount), the vpu-k2/k4/k8 backends.
//
// Bound on the H100: at decode (M = batch <= 8) bytes — the kb weight planes
// are read once and each weight word meets only M * ka activation words; at
// prefill M the integer units (and + popc + shift-add per plane pair and word
// pair: ka*kb times the 1-bit kernel's work).  Design: xnor_mismatch.cu's.
// A block owns an 8 x 32 output tile (one output per thread: warp = row,
// lane = weight row) and loops over Kw itself in 32-word stages, so blocks
// share nothing and need no split-K or atomics: the integer sums are
// deterministic.  A stage stages the ka activation planes of 8 rows and the
// kb weight planes of 32 rows in shared memory, each row read coalesced
// along Kw (one 128-byte line); the weight tile carries one pad word per row
// so that 32 lanes reading 32 rows at one word hit 32 banks.  Every term is
// non-negative, so the running int32 sum never exceeds the final S, which
// dispatch bounds by 2*K*Na*Nw < 2^31.  Words past Kw are never read and the
// K-tail bits are 0 in every plane of both operands, so AND adds nothing for
// them and no correction exists.  ka != kb works (w4a8): the plane counts
// are loop bounds, at most 8 each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kBM = 8;    // activation rows per block (one per warp)
constexpr int kBN = 32;   // weight rows per block (one per lane)
constexpr int kBKW = 32;  // words per shared-memory stage
constexpr int kThreads = kBM * kBN;

__global__ void __launch_bounds__(kThreads)
kbit_plane_gemm_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       int32_t* __restrict__ out, long long m, long long n,
                       long long kw, int ka, int kb) {
  __shared__ uint32_t sa[kMaxPlanes][kBM][kBKW];
  __shared__ uint32_t sb[kMaxPlanes][kBN][kBKW + 1];
  const int tid = threadIdx.x;
  const int tm = tid / kBN;
  const int tn = tid % kBN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  const long long a_plane = m * kw, b_plane = n * kw;
  int acc = 0;
  for (long long w0 = 0; w0 < kw; w0 += kBKW) {
    for (int i = tid; i < ka * kBM * kBKW; i += kThreads) {
      const int p = i / (kBM * kBKW), r = (i / kBKW) % kBM, c = i % kBKW;
      const long long gr = m0 + r, gc = w0 + c;
      sa[p][r][c] = (gr < m && gc < kw) ? a[p * a_plane + gr * kw + gc] : 0u;
    }
    for (int i = tid; i < kb * kBN * kBKW; i += kThreads) {
      const int p = i / (kBN * kBKW), r = (i / kBKW) % kBN, c = i % kBKW;
      const long long gr = n0 + r, gc = w0 + c;
      sb[p][r][c] = (gr < n && gc < kw) ? b[p * b_plane + gr * kw + gc] : 0u;
    }
    __syncthreads();
    const int words = static_cast<int>(kw - w0 < kBKW ? kw - w0 : kBKW);
    for (int c = 0; c < words; ++c) {
      for (int i = 0; i < ka; ++i) {
        const uint32_t av = sa[i][tm][c];
        for (int j = 0; j < kb; ++j) acc += __popc(av & sb[j][tn][c]) << (i + j);
      }
    }
    __syncthreads();
  }
  const long long row = m0 + tm, col = n0 + tn;
  if (row < m && col < n) out[row * n + col] = acc;
}

}  // namespace

extern "C" int repro_kbit_plane_gemm(const int32_t* a, const int32_t* b,
                                     int32_t* out, long long m, long long n,
                                     long long kw, int ka, int kb,
                                     cudaStream_t stream) {
  if (ka < 1 || ka > kMaxPlanes || kb < 1 || kb > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM));
  kbit_plane_gemm_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
      out, m, n, kw, ka, kb);
  return static_cast<int>(cudaGetLastError());
}
