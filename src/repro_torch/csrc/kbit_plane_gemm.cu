// k-bit bit-plane GEMM (DoReFa codes split into bit planes, paper Eq. 1):
// (ka, M, Kw) x (kb, N, Kw) 32-bit plane words -> (M, N) int32
//   S[m, n] = sum_{i < ka, j < kb} 2^(i+j) * sum_w popc(A_i[m, w] & B_j[n, w]),
// the integer dot of the activation codes with the weight codes, over
// exactly the Kw words given, for any 1 <= ka, kb <= 8.  Dispatch forms the
// DoReFa dot as (2S - Nw*T) / (Na*Nw).  The expert-batched form runs the
// same tiles over a leading expert axis: (E, ka, M, Kw) x (E, kb, N, Kw) ->
// (E, M, N), one expert per blockIdx.z, with 64-bit expert offsets
// (e*ka*M*Kw etc.: at 64 experts of 8 planes of 2048 x 64 words they pass
// 2^26).
//
// Replaces: src/repro/kernels/kbit_gemm.py, kbit_plane_gemm_pallas
// (_kbit_kernel, _plane_popcount), the vpu-k2/k4/k8 backends
// (repro_kbit_plane_gemm); and kbit_plane_gemm_batched_pallas
// (_kbit_kernel_batched), the MoE expert buckets of the vpu-k2/k4/k8
// backends (repro_kbit_plane_gemm_batched).
//
// Bound on the H100.  The function is AND + popcount + shift-add per plane
// pair and word pair on the CUDA cores, ka*kb*M*N*Kw popcounts, and __popc
// issues at 16 per SM per clock, a quarter of a logic op's rate.  Decode
// (M <= 32): granite's layers read 0.5-8 MB of weight planes a call (0.2-2.5
// us at 3.35 TB/s) and need 0.5-8 us of popcounts at the full rate, so a
// call is bound by its popcount and logic issue plus three latencies in a
// row: the launch, the activation words the zero-row check waits for, and
// the first weight chunk.  The MoE's dense 24-row buckets (64 experts, 23 MB
// of planes an up call) need 2.2 G popcounts, 530 us at the full rate, and
// their popcount and logic issue bounds them; routed buckets, zero past
// each expert's few rows, are bound by the blocks that stage their
// experts' rows and find them zero.  Prefill: the popcount and logic issue
// again, about 30x the int8 tensor cores' time for the same S (the
// tensor-core form of this function is kbit_mxu_gemm.cu).
//
// Carry-save popcounts cut the popcounts per word pair: a full adder folds
// three AND words into a sum word and a carry word of twice the weight, so
// 4 words take 3 popcounts (popc4) and a tree of four full adders takes 8
// words in 4 (popc8, Harley-Seal).
//
// Two tiles, chosen in the C entry point from the shapes and the SM count:
// - Decode (M <= kDecodeMaxRows; past that in row groups of 32 where the
//   prefill grid would fill under half the SMs): a warp owns 16 weight
//   rows, two lanes per row, each lane 4 of every 8-word chunk, and all the
//   block's activation rows.  Each weight word is read from device memory
//   once per call, through a private cp.async ring of kStages slots per
//   warp, into registers; the block's activation words are staged in
//   shared memory once and read as broadcasts, so one weight word meets all
//   M*ka activation words it pairs with without a reload.  kb is a template
//   argument (the weight planes stay in registers and the j loop unrolls)
//   and the i loop is unrolled to 8 and guarded; each plane pair adds its
//   popc4 shifted by j, each row its sum shifted by i.  Rows are contracted
//   one at a time into per-warp int32 sums in shared memory.  Where N/16
//   warp tiles cannot fill the SMs (granite q / k / v / o / down), the Kw
//   chunks are split among a block's warps and their partials added in
//   shared memory in a fixed order, with no atomics.
// - Prefill: 64 activation rows x 64 weight rows per block of 256 threads,
//   each thread a 4 x 4 grid of int32 sums; both operands' 8-word chunks go
//   through a kStages-deep cp.async ring shared by the block, and each
//   thread holds a chunk of 4 activation rows of one plane and of 4 weight
//   rows of one plane in registers: 16 popc8 per 16 words loaded.  Staged
//   rows are 12 words apart, so the 16-byte loads of 8 lanes hit 32 banks.
// Rows that are zero do no work.  A zero plane word ANDs to zero, so a row
// whose words are zero in every plane contributes exactly 0 to every S it
// meets: skipping it changes no bit.  The decode block stages its rows,
// marks those with a nonzero word in any plane over the whole Kw, and
// contracts only those, in ascending order, in a warp-uniform loop; the
// prefill block ORs its 64 rows' words before it stages anything.  A block
// with no such row stores zeros and reads no weight word.  The MoE buckets
// are dense at capacity T*k with each expert's rows packed at the front and
// zero planes (or code-0 rows) behind them, so at decode only the experts
// that received a token, and only their rows, are contracted, and at
// prefill only the row tiles that hold an expert's rows.  Every term is
// non-negative, so each running int32 sum stays below the final S, which
// dispatch bounds by 2*K*Na*Nw < 2^31.  Words past Kw are never read: the
// rings zero-fill them, and K-tail bits are 0 in every plane of both
// operands, so no correction exists.  16-byte cp.async needs Kw % 4 == 0
// and 16-byte aligned operands; other Kw copy word by word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kChunk = 8;           // words per row per ring chunk (32 bytes)
constexpr int kStages = 3;          // cp.async ring depth
constexpr int kDecodeMaxRows = 32;  // M at or below this runs the decode tile
constexpr int kDecodeWarps = 8;     // warps per decode block, at most
constexpr int kWarpRows = 16;       // weight rows per decode warp
constexpr int kPfM = 64;            // prefill block: activation rows
constexpr int kPfN = 64;            //   weight rows
constexpr int kPfThreads = 256;     //   16 x 16 threads of 4 x 4 sums
constexpr int kPfStride = kChunk + 4;  // words per staged prefill row
constexpr size_t kMaxSmem = 232448;  // the most an sm_90 block may opt into
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Words col..col+3 of one row into 16 bytes of shared memory; words that
// are absent (row out of range, col + i >= kw) are zero-filled and never
// read from device memory.  vec: rows are 16-byte aligned (Kw % 4 == 0).
__device__ __forceinline__ void copy_seg(uint32_t dst,
                                         const uint32_t* __restrict__ row,
                                         long long col, long long kw,
                                         bool row_ok, bool vec,
                                         const uint32_t* __restrict__ safe) {
  if (vec) {
    const bool ok = row_ok && col < kw;
    cp_async16(dst, ok ? row + col : safe, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = row_ok && col + i < kw;
      cp_async4(dst + 4 * i, ok ? row + col + i : safe, ok ? 4 : 0);
    }
  }
}

// Full adder on 32 bit lanes: x + y + z = sum + 2 * carry, lane by lane.
__device__ __forceinline__ void full_add(uint32_t x, uint32_t y, uint32_t z,
                                         uint32_t& sum, uint32_t& carry) {
  sum = x ^ y ^ z;
  carry = (x & y) | (z & (x ^ y));
}

// sum_w popc(x_w & y_w) over the 4 words of a 16-byte pair, in 3
// popcounts: one full adder folds the first three words into a sum word
// and a carry word of twice the weight.
__device__ __forceinline__ int popc4(const uint4& x, const uint4& y) {
  uint32_t sum, carry;
  full_add(x.x & y.x, x.y & y.y, x.z & y.z, sum, carry);
  return __popc(sum) + 2 * __popc(carry) + __popc(x.w & y.w);
}

// popc4(x0, y0) + popc4(x1, y1), 8 words in 4 popcounts: a carry-save
// tree of four full adders reduces 7 words of weight 1 to one word each of
// weight 1, 2 and 4 (Harley-Seal).
__device__ __forceinline__ int popc8(const uint4& x0, const uint4& y0,
                                     const uint4& x1, const uint4& y1) {
  uint32_t s1, c1, s2, c2, s3, c3, s4, c4;
  full_add(x0.x & y0.x, x0.y & y0.y, x0.z & y0.z, s1, c1);
  full_add(x0.w & y0.w, x1.x & y1.x, x1.y & y1.y, s2, c2);
  full_add(s1, s2, x1.z & y1.z, s3, c3);
  full_add(c1, c2, c3, s4, c4);
  return __popc(s3) + __popc(x1.w & y1.w) + 2 * __popc(s4) + 4 * __popc(c4);
}

// Decode tile: a block of R x S warps (blockDim.x = 32 * R * S, S =
// `splits`); warp (r, s) owns weight rows n0..n0+15 of row tile r (lane l:
// row n0 + (l & 15), words 4 * (l >> 4) .. + 3 of each chunk) and the s-th
// of S equal runs of the Kw / 8 chunks; every warp holds the block's up to
// 32 activation rows (row group blockIdx.y).  Dynamic shared memory: the
// activations (rows x ka planes x `stride` words, stride = 8 * chunks),
// the warps' rings (kStages slots of KB x 32 lanes x 16 bytes each), their
// int32 sums (rows x 32 each) and one live-row word per warp.
template <int KB>
__device__ __forceinline__ void decode_tile(const uint32_t* __restrict__ a,
                                            const uint32_t* __restrict__ b,
                                            int32_t* __restrict__ out,
                                            long long m, long long n,
                                            long long kw, int ka, int splits,
                                            int stride, bool vec) {
  extern __shared__ __align__(16) uint4 smem[];
  const long long m0 = static_cast<long long>(blockIdx.y) * kDecodeMaxRows;
  const int rows = static_cast<int>(
      m - m0 < kDecodeMaxRows ? m - m0 : kDecodeMaxRows);
  const int warps = blockDim.x >> 5;
  const int row_words = ka * stride;  // one activation row, all planes
  uint32_t* act = reinterpret_cast<uint32_t*>(smem);
  uint4* ring = smem + rows * row_words / 4;
  int* red = reinterpret_cast<int*>(ring + warps * kStages * KB * 32);
  uint32_t* live_w = reinterpret_cast<uint32_t*>(red + warps * rows * 32);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4;
  const int split = warp % splits, tile = warp / splits;
  const long long n0 =
      (static_cast<long long>(blockIdx.x) * (warps / splits) + tile) *
      kWarpRows;
  const long long col = n0 + (lane & 15);

  // the block's activation words, once: row r, plane p at act[(r*ka + p) *
  // stride]
  const int segs = stride / 4;
  for (int q = tid; q < rows * ka * segs; q += blockDim.x) {
    const int rp = q / segs, s = q % segs;
    const int r = rp / ka, p = rp % ka;
    copy_seg(smem_addr(act + rp * stride + 4 * s),
             a + (p * m + m0 + r) * kw, 4LL * s, kw, true, vec, a);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // the rows with a nonzero word in any plane (bit r of `live`)
  uint32_t mine = 0;
  for (int r = warp; r < rows; r += warps) {
    uint32_t any = 0;
    for (int q = lane; q < row_words; q += 32) any |= act[r * row_words + q];
    if (__any_sync(0xFFFFFFFFu, any != 0)) mine |= 1u << r;
  }
  if (lane == 0) live_w[warp] = mine;
  __syncthreads();
  uint32_t live = 0;
  for (int w = 0; w < warps; ++w) live |= live_w[w];

  const int first_row = split * 2 + half, row_step = 2 * splits;
  if (live == 0) {  // every S of the block is 0; no weight word is read
    if (col < n)
      for (int r = first_row; r < rows; r += row_step)
        out[(m0 + r) * n + col] = 0;
    return;
  }

  const long long chunks = (kw + kChunk - 1) / kChunk;
  const long long c_lo = chunks * split / splits;
  const int my = static_cast<int>(chunks * (split + 1) / splits - c_lo);
  const uint32_t* brow = b + col * kw;
  const bool row_ok = col < n;
  uint4* slots = ring + warp * kStages * KB * 32 + lane;
  auto issue = [&](int c) {  // chunk c of this warp's run into its slot
    if (c < my) {
      const long long w0 = (c_lo + c) * kChunk + 4 * half;
      uint4* slot = slots + (c % kStages) * KB * 32;
#pragma unroll
      for (int p = 0; p < KB; ++p)
        copy_seg(smem_addr(slot + p * 32), brow + p * n * kw, w0, kw, row_ok,
                 vec, b);
    }
    cp_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  int* acc = red + warp * rows * 32 + lane;
  for (int r = 0; r < rows; ++r) acc[r * 32] = 0;
  for (int c = 0; c < my; ++c) {
    cp_wait<kStages - 2>();  // chunk c has landed (this lane's copies)
    issue(c + kStages - 1);  // into the slot chunk c - 1 left
    const uint4* slot = slots + (c % kStages) * KB * 32;
    uint4 bw[KB];
#pragma unroll
    for (int p = 0; p < KB; ++p) bw[p] = slot[p * 32];
    const uint32_t* ac = act + (c_lo + c) * kChunk + 4 * half;
    for (uint32_t rest = live; rest; rest &= rest - 1) {
      const int r = __ffs(rest) - 1;
      const uint32_t* ar = ac + r * row_words;
      int s = 0;
#pragma unroll
      for (int i = 0; i < kMaxPlanes; ++i) {
        if (i >= ka) break;
        const uint4 av = *reinterpret_cast<const uint4*>(ar + i * stride);
        int t = 0;
#pragma unroll
        for (int j = 0; j < KB; ++j) t += popc4(av, bw[j]) << j;
        s += t << i;
      }
      acc[r * 32] += s;
    }
  }

  // the tile's sums: warps s = 0..S-1 of the row tile, each lane pair's
  // halves, added in that order
  cp_wait<0>();
  __syncthreads();
  if (col >= n) return;
  const int* tile_red = red + tile * splits * rows * 32 + (lane & 15);
  for (int r = first_row; r < rows; r += row_step) {
    int sum = 0;
    for (int s = 0; s < splits; ++s)
      sum += tile_red[(s * rows + r) * 32] + tile_red[(s * rows + r) * 32 + 16];
    out[(m0 + r) * n + col] = sum;
  }
}

// Prefill tile: activation rows m0..m0+63 x weight rows n0..n0+63; thread
// (tm, tn) = (tid / 16, tid % 16) owns activation rows m0 + 4*tm + r and
// weight rows n0 + tn + 16*c, r, c < 4.  A ring stage holds one 8-word
// chunk of the ka x 64 activation rows, then of the KB x 64 weight rows,
// kPfStride words apart.
template <int KB>
__device__ __forceinline__ void prefill_tile(const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             int32_t* __restrict__ out,
                                             long long m, long long n,
                                             long long kw, int ka, bool vec) {
  extern __shared__ __align__(16) uint4 smem[];
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem);
  const int stage_words = (ka + KB) * kPfM * kPfStride;
  const int tid = threadIdx.x, tn = tid & 15, tm = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.y) * kPfM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kPfN;

  // the block's activation rows are contiguous in each plane: any nonzero
  // word?  If none, every S of the tile is 0 and no weight word is read.
  const long long a_rows = m - m0 < kPfM ? m - m0 : kPfM;
  uint32_t any = 0;
  for (int p = 0; p < ka; ++p) {
    const uint32_t* base = a + (p * m + m0) * kw;
    for (long long q = tid; q < a_rows * kw; q += kPfThreads) any |= base[q];
  }
  if (!__syncthreads_or(any != 0)) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = m0 + 4 * tm + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long cn = n0 + tn + 16 * c;
        if (row < m && cn < n) out[row * n + cn] = 0;
      }
    }
    return;
  }

  const long long chunks = (kw + kChunk - 1) / kChunk;
  const int staged_rows = (ka + KB) * kPfM;
  auto issue = [&](long long c) {
    if (c < chunks) {
      uint32_t* st = stages + (c % kStages) * stage_words;
      for (int q = tid; q < staged_rows * 2; q += kPfThreads) {
        const int sr = q >> 1, s = q & 1;
        const bool is_a = sr < ka * kPfM;  // activation rows first
        const int pr = is_a ? sr : sr - ka * kPfM;
        const long long p = pr / kPfM;
        const long long gr = (is_a ? m0 : n0) + pr % kPfM;
        const uint32_t* base = is_a ? a + p * m * kw : b + p * n * kw;
        copy_seg(smem_addr(st + sr * kPfStride + 4 * s), base + gr * kw,
                 c * kChunk + 4 * s, kw, gr < (is_a ? m : n), vec, a);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  int acc[4][4] = {};
  for (long long c = 0; c < chunks; ++c) {
    cp_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();         // ... and everyone's; slot c - 1 is free
    issue(c + kStages - 1);
    const uint32_t* sa = stages + (c % kStages) * stage_words;
    const uint32_t* sb = sa + ka * kPfM * kPfStride;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      uint4 bw[4][2];  // the chunk's 8 words of 4 weight rows, plane j
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bw[cc][h] = *reinterpret_cast<const uint4*>(
              sb + (j * kPfM + tn + 16 * cc) * kPfStride + 4 * h);
#pragma unroll 1
      for (int i = 0; i < ka; ++i) {
        uint4 aw[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            aw[r][h] = *reinterpret_cast<const uint4*>(
                sa + (i * kPfM + 4 * tm + r) * kPfStride + 4 * h);
        const int sh = i + j;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] += popc8(aw[r][0], bw[cc][0], aw[r][1], bw[cc][1])
                          << sh;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = m0 + 4 * tm + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long cn = n0 + tn + 16 * c;
      if (row < m && cn < n) out[row * n + cn] = acc[r][c];
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(kDecodeWarps * 32)
kbit_plane_decode(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                  long long m, long long n, long long kw, int ka, int splits,
                  int stride, bool vec) {
  decode_tile<KB>(a, b, out, m, n, kw, ka, splits, stride, vec);
}

// blockIdx.z = expert: its (ka, M, Kw), (kb, N, Kw) and (M, N) slabs.
template <int KB>
__global__ void __launch_bounds__(kDecodeWarps * 32)
kbit_plane_batched_decode(const uint32_t* __restrict__ a,
                          const uint32_t* __restrict__ b,
                          int32_t* __restrict__ out, long long m, long long n,
                          long long kw, int ka, int splits, int stride,
                          bool vec) {
  const long long e = blockIdx.z;
  decode_tile<KB>(a + e * ka * m * kw, b + e * KB * n * kw, out + e * m * n,
                  m, n, kw, ka, splits, stride, vec);
}

template <int KB>
__global__ void __launch_bounds__(kPfThreads, 2)
kbit_plane_prefill(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                   long long m, long long n, long long kw, int ka, bool vec) {
  prefill_tile<KB>(a, b, out, m, n, kw, ka, vec);
}

template <int KB>
__global__ void __launch_bounds__(kPfThreads, 2)
kbit_plane_batched_prefill(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           int32_t* __restrict__ out, long long m, long long n,
                           long long kw, int ka, bool vec) {
  const long long e = blockIdx.z;
  prefill_tile<KB>(a + e * ka * m * kw, b + e * KB * n * kw, out + e * m * n,
                   m, n, kw, ka, vec);
}

using DecodeKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                              long long, long long, long long, int, int, int,
                              bool);
using PrefillKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                               long long, long long, long long, int, bool);

// [batched][kb - 1]
const DecodeKernel kDecode[2][kMaxPlanes] = {
    {kbit_plane_decode<1>, kbit_plane_decode<2>, kbit_plane_decode<3>,
     kbit_plane_decode<4>, kbit_plane_decode<5>, kbit_plane_decode<6>,
     kbit_plane_decode<7>, kbit_plane_decode<8>},
    {kbit_plane_batched_decode<1>, kbit_plane_batched_decode<2>,
     kbit_plane_batched_decode<3>, kbit_plane_batched_decode<4>,
     kbit_plane_batched_decode<5>, kbit_plane_batched_decode<6>,
     kbit_plane_batched_decode<7>, kbit_plane_batched_decode<8>}};
const PrefillKernel kPrefill[2][kMaxPlanes] = {
    {kbit_plane_prefill<1>, kbit_plane_prefill<2>, kbit_plane_prefill<3>,
     kbit_plane_prefill<4>, kbit_plane_prefill<5>, kbit_plane_prefill<6>,
     kbit_plane_prefill<7>, kbit_plane_prefill<8>},
    {kbit_plane_batched_prefill<1>, kbit_plane_batched_prefill<2>,
     kbit_plane_batched_prefill<3>, kbit_plane_batched_prefill<4>,
     kbit_plane_batched_prefill<5>, kbit_plane_batched_prefill<6>,
     kbit_plane_batched_prefill<7>, kbit_plane_batched_prefill<8>}};

// The SM count of a device, queried once.
cudaError_t sm_count(int dev, int* sms) {
  static int cached[kMaxDevices];  // 0: not queried yet
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *sms;
  return err;
}

// Lets `kernel` (index `id` of the 2 x 2 x 8 tables: [prefill][batched][kb
// - 1]) use up to kMaxSmem bytes of dynamic shared memory on `dev`, once per
// kernel and device.
cudaError_t allow_smem(const void* kernel, int id, int dev) {
  static bool done[kMaxDevices][2 * 2 * kMaxPlanes];
  if (dev < kMaxDevices && done[dev][id]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev][id] = true;
  return err;
}

int launch(bool batched, const int32_t* a32, const int32_t* b32, int32_t* out,
           long long e, long long m, long long n, long long kw, int ka, int kb,
           cudaStream_t stream) {
  if (ka < 1 || ka > kMaxPlanes || kb < 1 || kb > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e <= 0 || m <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* a = reinterpret_cast<const uint32_t*>(a32);
  const auto* b = reinterpret_cast<const uint32_t*>(b32);
  const bool vec = kw % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  const long long chunks = (kw + kChunk - 1) / kChunk;
  const long long pf_blocks =
      (n + kPfN - 1) / kPfN * ((m + kPfM - 1) / kPfM) * e;
  if (m <= kDecodeMaxRows || 2 * pf_blocks < sms) {
    // row groups of up to 32 activation rows (one at decode); past 32 rows
    // where the prefill tile's grid would leave most SMs idle
    const long long row_groups = (m + kDecodeMaxRows - 1) / kDecodeMaxRows;
    const long long g_rows = m < kDecodeMaxRows ? m : kDecodeMaxRows;
    const long long tiles = (n + kWarpRows - 1) / kWarpRows;
    const long long units = e * row_groups;  // (expert, row group) pairs
    // split K only until every SM gets a block's worth of warps: a power of
    // two, at most the block's warps, each split at least one chunk
    int splits = 1;
    while (splits < kDecodeWarps && 2 * splits <= chunks &&
           units * tiles * splits < static_cast<long long>(sms) * kDecodeWarps)
      splits *= 2;
    int row_tiles = 1;  // per block: share the activations while every SM
                        // still gets a block
    for (int r = kDecodeWarps / splits; r > 1; --r) {
      if ((tiles + r - 1) / r * units >= sms) {
        row_tiles = r;
        break;
      }
    }
    const long long stride = chunks * kChunk;
    const int warps = row_tiles * splits;
    const size_t smem = sizeof(uint32_t) * (g_rows * ka * stride + warps) +
                        sizeof(uint4) * warps * kStages * kb * 32 +
                        sizeof(int) * warps * g_rows * 32;
    if (smem <= kMaxSmem) {
      const DecodeKernel kernel = kDecode[batched][kb - 1];
      err = allow_smem(reinterpret_cast<const void*>(kernel),
                       batched * kMaxPlanes + kb - 1, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid(
          static_cast<unsigned>((tiles + row_tiles - 1) / row_tiles),
          static_cast<unsigned>(row_groups), static_cast<unsigned>(e));
      kernel<<<grid, warps * 32, smem, stream>>>(
          a, b, out, m, n, kw, ka, splits, static_cast<int>(stride), vec);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const size_t smem =
      sizeof(uint32_t) * kStages * (ka + kb) * kPfM * kPfStride;
  const PrefillKernel kernel = kPrefill[batched][kb - 1];
  err = allow_smem(reinterpret_cast<const void*>(kernel),
                   (2 + batched) * kMaxPlanes + kb - 1, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kPfN - 1) / kPfN),
                  static_cast<unsigned>((m + kPfM - 1) / kPfM),
                  static_cast<unsigned>(e));
  kernel<<<grid, kPfThreads, smem, stream>>>(a, b, out, m, n, kw, ka, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_kbit_plane_gemm(const int32_t* a, const int32_t* b,
                                     int32_t* out, long long m, long long n,
                                     long long kw, int ka, int kb,
                                     cudaStream_t stream) {
  return launch(false, a, b, out, 1, m, n, kw, ka, kb, stream);
}

extern "C" int repro_kbit_plane_gemm_batched(const int32_t* a, const int32_t* b,
                                             int32_t* out, long long e,
                                             long long m, long long n,
                                             long long kw, int ka, int kb,
                                             cudaStream_t stream) {
  return launch(true, a, b, out, e, m, n, kw, ka, kb, stream);
}
