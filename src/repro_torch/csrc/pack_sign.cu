// Sign-pack activation prologue: (M, K) float32 -> (M, Kw) 32-bit words,
// bit i of word w = (x[row, 32w + i] >= 0), LSB first; bits past K are 0.
//
// Replaces: src/repro/kernels/pack_bits.py, pack_sign_pallas (_pack_kernel),
// the fused "binarize input" stage that runs before every packed GEMM.
//
// Bound on the H100: bytes.  It reads 4 bytes per value and writes 1/8 byte
// per value; one compare per value is nothing beside that.  Design: one warp
// per (row, word).  Lane i reads x[row, 32w + i], so a warp reads one
// contiguous 128-byte line and neighbouring warps read neighbouring lines;
// __ballot_sync of the lanes' predicates IS the word, already in LSB-first
// lane order, so no shifts, no shared memory and no second pass.  The ragged
// K edge is masked in the kernel (lanes past K vote 0), so callers need not
// pad the floats with -1.0 the way the TPU path does.  NaN compares false
// (bit 0) and -0.0f >= 0 is true (bit 1), as in the JAX package.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pack_sign_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                 long long m, long long k, long long kw) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // warp is uniform across the warp: whole warps leave together, so the
  // full-mask ballot below always has all 32 lanes present
  if (warp >= m * kw) return;
  const int lane = threadIdx.x & 31;
  const long long row = warp / kw;
  const long long col = (warp - row * kw) * 32 + lane;
  const bool bit = col < k && x[row * k + col] >= 0.0f;
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[warp] = word;  // out is (M, Kw) row-major: index = warp
}

}  // namespace

extern "C" int repro_pack_sign(const float* x, int32_t* out, long long m,
                               long long k, long long kw,
                               cudaStream_t stream) {
  const long long warps = m * kw;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pack_sign_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     stream>>>(x, reinterpret_cast<uint32_t*>(out), m, k, kw);
  return static_cast<int>(cudaGetLastError());
}
