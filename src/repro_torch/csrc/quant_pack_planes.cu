// DoReFa activation prologue (paper Eq. 1): (M, K) float32 ->
//   planes (a_bits, M, Kw) 32-bit words: bit l of planes[i, row, w] is bit i
//     of code[row, 32w + l], LSB first; bits past K are 0 in every plane;
//   t_sum (M, 1) int32: the code row-sums sum_k code[row, k];
// with code = rint(clamp(x, 0, 1) * (2^a_bits - 1)), 2 <= a_bits <= 8.
//
// Replaces: src/repro/kernels/pack_bits.py, quant_pack_planes_pallas
// (_quant_pack_planes_kernel), the fused quantize -> plane-pack prologue
// that runs before every k-bit packed GEMM (the vpu-k* and mxu-k* backends).
//
// Bound on the H100: bytes.  It reads 4 bytes per value and writes a_bits/8
// bytes per value plus 4 bytes per row; a clamp, a multiply, a rint and
// a_bits ballots per value are nothing beside that.  Design: one block per
// row, 8 warps; warp j packs words j, j + 8, ... of the row.  Lane l reads
// x[row, 32w + l], so a warp reads one contiguous 128-byte line; lanes past
// K take code 0, so the ragged edge is masked here and callers need not pad
// (the TPU path pads with -1.0 instead).  Per plane i, __ballot_sync of the
// lanes' bit i IS the plane word in LSB-first lane order (as in
// pack_sign.cu); lane i keeps plane i's word and the first a_bits lanes
// store them.  T is an integer sum: per lane over its words, then over the
// warp by shuffles, then over the 8 warps in shared memory — integer adds,
// so the result is the same in any order.
//
// Rounding: rintf is round-half-to-even, as torch.round and jnp.round; the
// product clamp(x) * n is one fp32 multiply (__fmul_rn, never contracted),
// as in the JAX package.  NaN is outside the contract (the JAX package's
// uint32 cast of NaN is undefined): fmaxf(NaN, 0) is 0, so here NaN gives
// code 0.  -0.0 gives code 0; +inf gives the top code, -inf code 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
quant_pack_planes_kernel(const float* __restrict__ x,
                         uint32_t* __restrict__ planes,
                         int32_t* __restrict__ t_sum, long long m, long long k,
                         long long kw, int a_bits) {
  __shared__ int warp_sums[kWarps];
  const long long row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float n = static_cast<float>((1 << a_bits) - 1);
  const float* xr = x + row * k;
  const long long plane_stride = m * kw;
  int t = 0;
  // w is uniform across the warp, so every ballot has all 32 lanes present
  for (long long w = warp; w < kw; w += kWarps) {
    const long long col = w * 32 + lane;
    unsigned code = 0u;
    if (col < k) {
      const float u = fminf(fmaxf(xr[col], 0.0f), 1.0f);
      code = static_cast<unsigned>(rintf(__fmul_rn(u, n)));
    }
    t += static_cast<int>(code);
    uint32_t mine = 0u;
    for (int i = 0; i < a_bits; ++i) {
      const uint32_t word = __ballot_sync(0xffffffffu, (code >> i) & 1u);
      if (lane == i) mine = word;
    }
    if (lane < a_bits) planes[lane * plane_stride + row * kw + w] = mine;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  if (lane == 0) warp_sums[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += warp_sums[i];
    t_sum[row] = s;
  }
}

}  // namespace

extern "C" int repro_quant_pack_planes(const float* x, int32_t* planes,
                                       int32_t* t_sum, long long m,
                                       long long k, long long kw, int a_bits,
                                       cudaStream_t stream) {
  if (a_bits < 2 || a_bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  quant_pack_planes_kernel<<<static_cast<unsigned>(m), kThreads, 0, stream>>>(
      x, reinterpret_cast<uint32_t*>(planes), t_sum, m, k, kw, a_bits);
  return static_cast<int>(cudaGetLastError());
}
