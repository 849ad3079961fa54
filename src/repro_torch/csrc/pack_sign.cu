// Sign-pack activation prologue: (M, K) float32 -> (M, Kw) 32-bit words,
// bit i of word w = (x[row, 32w + i] >= 0), LSB first; bits past K are 0.
//
// Replaces: src/repro/kernels/pack_bits.py, pack_sign_pallas (_pack_kernel),
// the fused "binarize input" stage that runs before every packed GEMM.
//
// Bound on the H100: not the compares (one a value, nothing beside the 4
// bytes a value reads) but the bytes in flight and the launch chain.  A
// decode call moves 32-200 KB, which the HBM rate passes in 0.01-0.06 us,
// so what it costs is the graph node (the launch), one load round trip, the
// pack and the store.  A prefill call moves 2-8.4 MB, all of which must be
// in flight at once for the memory rate to show: at 0.6-0.8 us of loaded
// latency, 3.35 TB/s asks for 15-20 KB per SM.  The design:
//
// - A warp owns S consecutive segments of a row (S = 2 or 4), a segment
//   being 128 floats, 4 words: lane l reads floats 4l..4l+3 of each with
//   one 16-byte load, so a warp's load is one contiguous 512-byte run, and
//   every load of the warp goes out before the first compare.  Where a
//   row's base is not 16-byte aligned (K % 4 != 0, or a view at an odd
//   float offset) the same floats are read by 4-byte loads.  Floats past K
//   take -1.0 (bit 0): the ragged edge is masked here, so callers need not
//   pad the floats the way the TPU path does.
// - No serial chain in the pack: four ballots a segment (ballot c: bit l =
//   float 4l + c >= 0) hold its 4 words, byte j of each ballot making word
//   j.  Lane d picks the ballots of segment d / 4 (a tree of selects) and
//   interleaves byte d % 4 of the four into word d; the warp's 4S lanes
//   then store their words in one coalesced store.
// - The plan comes from the host (make_plan, from M and Kw): S and the
//   warps a block.  The row is blockIdx.x and a block's warps own
//   consecutive segments of it (blockIdx.y the block of a long row); every
//   index inside a row is 32-bit, with no division, and one wide multiply
//   gives the row.
//
// NaN compares false (bit 0) and -0.0f >= 0 is true (bit 1), as in the JAX
// package.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSegFloats = 128;  // a warp's 16-byte loads: one a lane
constexpr int kSegWords = 4;     // words a segment
constexpr int kWarps = 4;        // a block
constexpr int kDecodeRows = 32;  // M at or below: decode

struct Plan {
  int segs;   // a warp: 16-byte loads a lane, all issued before the pack
  int warps;  // a block, on consecutive segments of one row
};

// Decode (M <= 32): 2 segments a warp (8 words), so a block of 4 warps
// reads 4 KB and a call's few rows spread over 8-44 blocks; prefill: 4
// segments a warp (16 words), 8 KB a block.  A long row (K 8192, 10944)
// spans several blocks (grid.y); a row shorter than a block's words gets
// fewer warps.  More loads a lane did not pay (at 8 the compiler no longer
// issues them all before the first compare), nor did fewer or more warps a
// block.
Plan make_plan(long long m, long long kw) {
  Plan p{m <= kDecodeRows ? 2 : 4, kWarps};
  const long long per_warp = p.segs * kSegWords;
  const long long need = (kw + per_warp - 1) / per_warp;  // warps a row
  if (need < p.warps) p.warps = static_cast<int>(need);
  return p;
}

// Floats c..c+3 of a row; -1.0 (bit 0) past K.  The load itself is
// unconditional (a column past K reads the row's last float4, or float, and
// the select drops it), so that the compiler can issue every load of a warp
// before the first compare; a load under a branch is sunk to its use.
// kVec: one 16-byte load (K % 4 == 0, so the four are all in the row or all
// past it).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ xr, int c,
                                        int k) {
  if constexpr (kVec) {
    const float4 t = *reinterpret_cast<const float4*>(xr + min(c, k - 4));
    return c < k ? t : make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
  } else {
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = xr[min(c + j, k - 1)];
      f[j] = c + j < k ? t : -1.0f;
    }
    return make_float4(f[0], f[1], f[2], f[3]);
  }
}

// b[seg] for a lane-dependent seg < S (1, 2 or 4): a tree of selects,
// one level a bit of seg, no local memory
template <int S>
__device__ __forceinline__ uint32_t pick(uint32_t (&b)[S], int seg) {
#pragma unroll
  for (int step = 1; step < S; step *= 2)
#pragma unroll
    for (int i = 0; i + step < S; i += 2 * step)
      b[i] = (seg & step) ? b[i + step] : b[i];
  return b[0];
}

// bit i of a byte to bit 4i
__device__ __forceinline__ uint32_t spread4(uint32_t v) {
  v &= 0xffu;
  v = (v | v << 12) & 0x000f000fu;
  v = (v | v << 6) & 0x03030303u;
  return (v | v << 3) & 0x11111111u;
}

template <bool kVec, int S>
__global__ void __launch_bounds__(kWarps * 32)
pack_sign_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                 int k, int kw) {
  const int lane = threadIdx.x & 31;
  const int w0 =
      (blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5)) * (S * kSegWords);
  // uniform across the warp: whole warps leave, so the ballots below
  // always have all 32 lanes
  if (w0 >= kw) return;
  const float* xr = x + static_cast<size_t>(blockIdx.x) * k;
  const int col = w0 * 32 + 4 * lane;
  float4 v[S];
#pragma unroll
  for (int s = 0; s < S; ++s)  // every load goes out first
    v[s] = load4<kVec>(xr, col + s * kSegFloats, k);
  // ballot c of segment s: bit l = float 4l + c of the segment
  uint32_t b0[S], b1[S], b2[S], b3[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b0[s] = __ballot_sync(0xffffffffu, v[s].x >= 0.0f);
    b1[s] = __ballot_sync(0xffffffffu, v[s].y >= 0.0f);
    b2[s] = __ballot_sync(0xffffffffu, v[s].z >= 0.0f);
    b3[s] = __ballot_sync(0xffffffffu, v[s].w >= 0.0f);
  }
  // lane d packs word d: segment d / 4, whose floats 32j + 4i + c (j =
  // d % 4) are bits 8j + i of its ballots c, interleaved to bit 4i + c
  const int seg = lane / kSegWords, sh = 8 * (lane % kSegWords);
  const uint32_t word = spread4(pick(b0, seg) >> sh) |
                        spread4(pick(b1, seg) >> sh) << 1 |
                        spread4(pick(b2, seg) >> sh) << 2 |
                        spread4(pick(b3, seg) >> sh) << 3;
  const int w = w0 + lane;
  if (lane < S * kSegWords && w < kw)
    out[static_cast<size_t>(blockIdx.x) * kw + w] = word;
}

template <bool kVec>
cudaError_t launch(const Plan& p, dim3 grid, const float* x, uint32_t* out,
                   int k, int kw, cudaStream_t stream) {
  const unsigned threads = static_cast<unsigned>(p.warps) * 32u;
  if (p.segs == 2)
    pack_sign_kernel<kVec, 2><<<grid, threads, 0, stream>>>(x, out, k, kw);
  else
    pack_sign_kernel<kVec, 4><<<grid, threads, 0, stream>>>(x, out, k, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_pack_sign(const float* x, int32_t* out, long long m,
                               long long k, long long kw,
                               cudaStream_t stream) {
  if (m <= 0 || kw <= 0) return 0;
  // 32-bit columns inside a row, the last warp's segments included; rows
  // and a row's blocks within the grid's limits
  if (k > INT_MAX - 4096 || m > INT_MAX) return cudaErrorInvalidValue;
  const Plan p = make_plan(m, kw);
  const long long per_block = static_cast<long long>(p.segs) * p.warps;
  const long long segs = (kw + kSegWords - 1) / kSegWords;
  const long long blocks = (segs + per_block - 1) / per_block;  // a row
  if (blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(m), static_cast<unsigned>(blocks));
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  const int k32 = static_cast<int>(k), kw32 = static_cast<int>(kw);
  return static_cast<int>(vec ? launch<true>(p, grid, x, o, k32, kw32, stream)
                              : launch<false>(p, grid, x, o, k32, kw32, stream));
}
