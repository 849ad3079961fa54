// Unpack-to-int8 binary GEMM on the tensor cores: (M, Kw) x (N, Kw) 32-bit
// words -> (M, N) int32 "padded" +-1 dot over exactly the Kw words given:
// every bit counts as +1 (bit 1) or -1 (bit 0), so the zero K-tail bits of
// the last word pair up as (-1)(-1) = +1 and inflate the dot by
// Kw*32 - k_true, which dispatch subtracts (xnor_gemm.mxu_pad_inflation
// with the Kw passed here).  The result equals 32*Kw - 2*popcount(a ^ b).
//
// The expert-batched form runs the same tiles over a leading expert axis:
// (E, M, Kw) x (E, N, Kw) -> (E, M, N), one expert per blockIdx.z, with
// 64-bit expert offsets.
//
// Replaces: src/repro/kernels/xnor_gemm.py, xnor_dot_mxu_pallas
// (_mxu_kernel, _unpack_pm1_i8), the "mxu" backend (repro_xnor_dot_mxu);
// and xnor_dot_mxu_batched_pallas (_mxu_kernel_batched), the MoE expert
// buckets of the "mxu" backend (repro_xnor_dot_mxu_batched).
//
// Bound on the H100.  Decode (M <= 32 rows): the packed weights' bytes,
// read once; granite's 0.5-2 MB matrices take under 1 us at 3.35 TB/s, so
// in practice the launch and one load round trip bound a call, and at the
// MoE's 64 experts (23 MB a call) the integer unpack work.  Prefill: the
// 2*M*N*K int8 operations on the tensor cores; but with mma.sync every
// fragment register costs two integer instructions, about five per mma in
// the prefill tile, and that integer issue, not the tensor cores, bounds
// it.  wgmma with one unpacked operand in shared memory is its next step.
//
// Fragments come straight from the words, in registers.  mma.m16n8k32 sums
// over its 32 K lanes in any order, so a lane need only take the same bit
// in A and in B.  Thread t of a quad holds words 4t..4t+3 of a 16-word
// chunk; for word i and step h its A registers 0/2 are bit slices 2h and
// 2h + 1 of that word (byte j <- bit 8j + 2h, resp. 8j + 2h + 1; +1 where
// the bit is 1, -1 where it is 0), and its B registers the same slices of
// the activation word with the same index.  Four steps cover a word's 32
// bits; two integer ops per register.  Words at or past Kw give zero A
// registers, so the kernel contracts exactly Kw words.
//
// Two tiles, chosen in the C entry point from the shapes and the SM count:
// - Decode (M <= kDecodeMaxRows): swap-AB.  Weight rows fill the m16 A slot
//   (16 per warp), activation rows the n8 B slot (up to 4 fragments), so
//   each weight word is read and unpacked once per call whatever M is.  The
//   block stages the activation words in shared memory once; each warp
//   streams its weight rows through a private cp.async ring of kStages
//   16-byte-per-thread slots (no block barrier in the loop).  Where N/16
//   warp tiles are too few to fill the SMs, the K chunks are split among
//   the warps of a block and their int32 partials added in shared memory in
//   a fixed order (no atomics); R row tiles share a block's activations
//   when that still leaves a block per SM.
// - Prefill: a 128-weight-row x 64-activation-row block of 8 warps (each
//   32 x 32: two A and four B fragments), both operands' words streamed
//   through a kStages-deep cp.async ring of 16-word chunks, so each weight
//   word is unpacked once per 64 activation rows.
// A chunk row is 64 bytes, so a quad's 16-byte reads of two neighbouring
// rows fall on the two halves of the banks: shared-memory reads are free of
// bank conflicts (the decode activation rows are padded to 16 mod 32
// words).  Rows are 16-byte aligned when Kw % 4 == 0; other Kw copy word by
// word (cp.async of 4 bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 16;         // words per row per chunk (64 bytes)
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kDecodeMaxRows = 32;  // M at or below this runs the decode tile
constexpr int kDecodeWarps = 8;    // warps per decode block, at most
constexpr int kSlotUint4 = 64;     // a warp's ring slot: 2 rows x 32 lanes
constexpr int kPfN = 128;          // prefill block: weight rows
constexpr int kPfM = 64;           //   activation rows
constexpr int kPfThreads = 256;    //   8 warps, 4 (N) x 2 (M) of 32 x 32
constexpr int kPfStageWords = (kPfN + kPfM) * kWords;
constexpr size_t kPfSmem = sizeof(uint32_t) * kStages * kPfStageWords;
static_assert(kPfSmem <= 48 * 1024, "the prefill ring fits the default limit");
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
// read from device memory.  kVec: rows are 16-byte aligned (Kw % 4 == 0).
template <bool kVec>
__device__ __forceinline__ void copy_seg(uint32_t dst,
                                         const uint32_t* __restrict__ row,
                                         long long col, long long kw,
                                         bool row_ok,
                                         const uint32_t* __restrict__ safe) {
  if (kVec) {
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

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Bit slices 2h and 2h + 1 of a word as +-1 int8 lanes: byte j of lo is +1
// where bit 8j + 2h is set and -1 where it is clear (0x01 / 0xFF), hi the
// same for bit 8j + 2h + 1.  No byte carries into the next: (0 or 1)*0xFE.
__device__ __forceinline__ void pm1_pair(uint32_t w, int h, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t u = w >> (2 * h);
  lo = (u & 0x01010101u) * 0xFFFFFF02u + 0xFFFFFFFFu;  // ~(x * 0xFE)
  hi = (u & 0x02020202u) * 0xFFFFFF81u + 0xFFFFFFFFu;  // ~(x * 0x7F)
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One thread's share of a 16-word chunk: A fragments kFa from weight words
// wv[f][0] (row g) / wv[f][1] (row g + 8), B fragments kFb from activation
// words xv[j] (row g of fragment j).  kMasked: only the first `valid` of the
// thread's 4 words lie before Kw; the others give zero A registers (the
// branch is on data, not on control: mma.sync needs the whole warp).
template <int kFa, int kFb, bool kMasked>
__device__ __forceinline__ void contract_chunk(int (&acc)[kFa][kFb][4],
                                               const uint4 (&wv)[kFa][2],
                                               const uint4 (&xv)[kFb],
                                               int valid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t keep = (!kMasked || i < valid) ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint32_t af[kFa][4];
#pragma unroll
      for (int f = 0; f < kFa; ++f) {
        pm1_pair(word(wv[f][0], i), h, af[f][0], af[f][2]);
        pm1_pair(word(wv[f][1], i), h, af[f][1], af[f][3]);
        if (kMasked) {
#pragma unroll
          for (int r = 0; r < 4; ++r) af[f][r] &= keep;
        }
      }
#pragma unroll
      for (int j = 0; j < kFb; ++j) {
        uint32_t b0, b1;
        pm1_pair(word(xv[j], i), h, b0, b1);
#pragma unroll
        for (int f = 0; f < kFa; ++f) mma_s8(acc[f][j], af[f], b0, b1);
      }
    }
  }
}

// C fragment (16 x 8): regs 0/1 row g, regs 2/3 row g + 8; col 2t + (i & 1).
// Rows are weight rows (N), columns activation rows (M).
__device__ __forceinline__ void store_frag(int32_t* __restrict__ out,
                                           const int (&c)[4], long long nrow,
                                           long long mcol, long long m,
                                           long long n) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = nrow + (i >= 2 ? 8 : 0), col = mcol + (i & 1);
    if (r < n && col < m) out[col * n + r] = c[i];
  }
}

// Decode tile: a block of R x S warps (blockDim.x = 32 * R * S, S =
// `splits`); warp (r, s) owns weight rows n0..n0+15 of row tile r and the
// s-th of S equal runs of the Kw / 16 chunks; every warp holds all kNf * 8
// activation rows.  Dynamic shared memory: the activations (kNf * 8 rows of
// `stride` words, stride = 16 mod 32), then the warps' rings (kStages slots
// of 2 x 32 x 16 bytes each), reused for the split-K partials.
template <int kNf, bool kVec>
__device__ __forceinline__ void decode_tile(const uint32_t* __restrict__ a,
                                            const uint32_t* __restrict__ b,
                                            int32_t* __restrict__ out,
                                            long long m, long long n,
                                            long long kw, int splits,
                                            int stride) {
  extern __shared__ __align__(16) uint4 smem[];
  constexpr int kRows = kNf * 8;
  uint32_t* act = reinterpret_cast<uint32_t*>(smem);
  uint4* ring = smem + kRows * stride / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = warp % splits;
  const int tiles_per_block = (blockDim.x >> 5) / splits;
  const long long n0 =
      (static_cast<long long>(blockIdx.x) * tiles_per_block + warp / splits) *
      16;
  const long long chunks = (kw + kWords - 1) / kWords;
  const long long c_lo = chunks * split / splits;
  const int my = static_cast<int>(chunks * (split + 1) / splits - c_lo);

  // the activation words, once per block (the oldest cp.async group)
  const int segs = static_cast<int>(chunks) * 4;
  for (int q = tid; q < kRows * segs; q += blockDim.x) {
    const int r = q / segs, s = q % segs;
    copy_seg<kVec>(smem_addr(act + r * stride + 4 * s), a + r * kw, 4LL * s,
                   kw, r < m, a);
  }
  cp_commit();

  // the warp's weight chunks through its ring: this thread copies, and
  // later reads, only its own 2 x 16 bytes per chunk
  const uint32_t* row0 = b + (n0 + g) * kw;
  const uint32_t* row1 = b + (n0 + g + 8) * kw;
  const bool ok0 = n0 + g < n, ok1 = n0 + g + 8 < n;
  uint4* mine = ring + warp * kStages * kSlotUint4 + lane;
  auto issue = [&](int j) {
    if (j < my) {
      const long long col = (c_lo + j) * kWords + 4 * t;
      uint4* slot = mine + (j % kStages) * kSlotUint4;
      copy_seg<kVec>(smem_addr(slot), row0, col, kw, ok0, b);
      copy_seg<kVec>(smem_addr(slot + 32), row1, col, kw, ok1, b);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  cp_wait<kStages - 1>();  // the activations have landed
  __syncthreads();

  int acc[1][kNf][4] = {};
  for (int j = 0; j < my; ++j) {
    cp_wait<kStages - 2>();  // chunk j has landed
    issue(j + kStages - 1);  // into the slot chunk j - 1 left
    const uint4* slot = mine + (j % kStages) * kSlotUint4;
    const uint4 wv[1][2] = {{slot[0], slot[32]}};
    const long long c = c_lo + j;
    uint4 xv[kNf];
#pragma unroll
    for (int f = 0; f < kNf; ++f)
      xv[f] = *reinterpret_cast<const uint4*>(
          act + (f * 8 + g) * stride + c * kWords + 4 * t);
    if ((c + 1) * kWords <= kw) {
      contract_chunk<1, kNf, false>(acc, wv, xv, 4);
    } else {
      const long long left = kw - c * kWords - 4 * t;
      contract_chunk<1, kNf, true>(acc, wv, xv,
                                   left < 0 ? 0 : static_cast<int>(left));
    }
  }

  if (splits == 1) {
#pragma unroll
    for (int f = 0; f < kNf; ++f)
      store_frag(out, acc[0][f], n0 + g, f * 8 + 2 * t, m, n);
    return;
  }
  // split-K: partials to shared memory (over the rings), then warp s = 0 of
  // each row tile adds s = 0, 1, ..., S - 1 in that order
  cp_wait<0>();
  __syncthreads();
  int* red = reinterpret_cast<int*>(ring);
#pragma unroll
  for (int f = 0; f < kNf; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * kNf * 4 + f * 4 + i) * 32 + lane] = acc[0][f][i];
  __syncthreads();
  if (split != 0) return;
#pragma unroll
  for (int f = 0; f < kNf; ++f) {
    int c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int sum = 0;
      for (int s = 0; s < splits; ++s)
        sum += red[((warp + s) * kNf * 4 + f * 4 + i) * 32 + lane];
      c[i] = sum;
    }
    store_frag(out, c, n0 + g, f * 8 + 2 * t, m, n);
  }
}

// Prefill tile: weight rows n0..n0+127 x activation rows m0..m0+63; warp
// (wn, wm) = (warp % 4, warp / 4) owns weight rows wn*32.. and activation
// rows wm*32..  A ring stage holds the 128 + 64 rows' words of one chunk.
template <bool kVec>
__device__ __forceinline__ void prefill_tile(const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             int32_t* __restrict__ out,
                                             long long m, long long n,
                                             long long kw) {
  extern __shared__ __align__(16) uint4 smem[];
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp & 3, wm = warp >> 2;
  const long long n0 = static_cast<long long>(blockIdx.x) * kPfN;
  const long long m0 = static_cast<long long>(blockIdx.y) * kPfM;
  const long long chunks = (kw + kWords - 1) / kWords;

  auto issue = [&](long long c) {
    if (c < chunks) {
      uint32_t* st = stages + (c % kStages) * kPfStageWords;
#pragma unroll
      for (int q = tid; q < (kPfN + kPfM) * 4; q += kPfThreads) {
        const int r = q >> 2, s = q & 3;
        const bool is_w = r < kPfN;  // weight rows first, then activations
        const long long gr = is_w ? n0 + r : m0 + (r - kPfN);
        const uint32_t* base = is_w ? b : a;
        copy_seg<kVec>(smem_addr(st + r * kWords + 4 * s), base + gr * kw,
                       c * kWords + 4 * s, kw, gr < (is_w ? n : m), base);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  int acc[2][4][4] = {};
  for (long long c = 0; c < chunks; ++c) {
    cp_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();         // ... and everyone's; slot c - 1 is free
    issue(c + kStages - 1);
    const uint32_t* st = stages + (c % kStages) * kPfStageWords;
    uint4 wv[2][2], xv[4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        wv[f][hf] = *reinterpret_cast<const uint4*>(
            st + (wn * 32 + f * 16 + hf * 8 + g) * kWords + 4 * t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xv[j] = *reinterpret_cast<const uint4*>(
          st + (kPfN + wm * 32 + j * 8 + g) * kWords + 4 * t);
    if ((c + 1) * kWords <= kw) {
      contract_chunk<2, 4, false>(acc, wv, xv, 4);
    } else {
      const long long left = kw - c * kWords - 4 * t;
      contract_chunk<2, 4, true>(acc, wv, xv,
                                 left < 0 ? 0 : static_cast<int>(left));
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_frag(out, acc[f][j], n0 + wn * 32 + f * 16 + g,
                 m0 + wm * 32 + j * 8 + 2 * t, m, n);
}

template <int kNf, bool kVec>
__global__ void __launch_bounds__(kDecodeWarps * 32)
xnor_dot_mxu_decode(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                    long long m, long long n, long long kw, int splits,
                    int stride) {
  decode_tile<kNf, kVec>(a, b, out, m, n, kw, splits, stride);
}

// blockIdx.z = expert: its (M, Kw), (N, Kw) and (M, N) slabs.
template <int kNf, bool kVec>
__global__ void __launch_bounds__(kDecodeWarps * 32)
xnor_dot_mxu_batched_decode(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            int32_t* __restrict__ out, long long m,
                            long long n, long long kw, int splits,
                            int stride) {
  const long long e = blockIdx.z;
  decode_tile<kNf, kVec>(a + e * m * kw, b + e * n * kw, out + e * m * n, m,
                         n, kw, splits, stride);
}

template <bool kVec>
__global__ void __launch_bounds__(kPfThreads, 2)
xnor_dot_mxu_prefill(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                     long long m, long long n, long long kw) {
  prefill_tile<kVec>(a, b, out, m, n, kw);
}

template <bool kVec>
__global__ void __launch_bounds__(kPfThreads, 2)
xnor_dot_mxu_batched_prefill(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             int32_t* __restrict__ out, long long m,
                             long long n, long long kw) {
  const long long e = blockIdx.z;
  prefill_tile<kVec>(a + e * m * kw, b + e * n * kw, out + e * m * n, m, n,
                     kw);
}

using DecodeKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                              long long, long long, long long, int, int);
using PrefillKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                               long long, long long, long long);

// [batched][vec][kNf - 1]
const DecodeKernel kDecode[2][2][4] = {
    {{xnor_dot_mxu_decode<1, false>, xnor_dot_mxu_decode<2, false>,
      xnor_dot_mxu_decode<3, false>, xnor_dot_mxu_decode<4, false>},
     {xnor_dot_mxu_decode<1, true>, xnor_dot_mxu_decode<2, true>,
      xnor_dot_mxu_decode<3, true>, xnor_dot_mxu_decode<4, true>}},
    {{xnor_dot_mxu_batched_decode<1, false>,
      xnor_dot_mxu_batched_decode<2, false>,
      xnor_dot_mxu_batched_decode<3, false>,
      xnor_dot_mxu_batched_decode<4, false>},
     {xnor_dot_mxu_batched_decode<1, true>,
      xnor_dot_mxu_batched_decode<2, true>,
      xnor_dot_mxu_batched_decode<3, true>,
      xnor_dot_mxu_batched_decode<4, true>}}};
// [batched][vec]
const PrefillKernel kPrefill[2][2] = {
    {xnor_dot_mxu_prefill<false>, xnor_dot_mxu_prefill<true>},
    {xnor_dot_mxu_batched_prefill<false>, xnor_dot_mxu_batched_prefill<true>}};

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

// Lets decode kernel [batched][vec][nf - 1] use up to kMaxSmem bytes of
// dynamic shared memory on `dev`, once per kernel and device.  (The prefill
// tile stays within the default 48 KB.)
cudaError_t allow_decode_smem(int batched, int vec, int nf, int dev) {
  static bool done[kMaxDevices][2][2][4];
  if (dev < kMaxDevices && done[dev][batched][vec][nf - 1]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kDecode[batched][vec][nf - 1]),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev][batched][vec][nf - 1] = true;
  return err;
}

int launch(bool batched, const int32_t* a32, const int32_t* b32, int32_t* out,
           long long e, long long m, long long n, long long kw,
           cudaStream_t stream) {
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
  const long long chunks = (kw + kWords - 1) / kWords;
  if (m <= kDecodeMaxRows) {
    const int nf = static_cast<int>((m + 7) / 8);
    const long long tiles = (n + 15) / 16;
    // split K only until every SM gets a block's worth of warps: a power of
    // two, at most the block's warps, each split at least one chunk
    int splits = 1;
    while (splits < kDecodeWarps && 2 * splits <= chunks &&
           e * tiles * splits < static_cast<long long>(sms) * kDecodeWarps)
      splits *= 2;
    int rows = 1;  // row tiles per block: share the activations while every
                   // SM still gets a block
    for (int r = kDecodeWarps / splits; r > 1; --r) {
      if ((tiles + r - 1) / r * e >= sms) {
        rows = r;
        break;
      }
    }
    long long stride = chunks * kWords;
    if (stride % 32 == 0) stride += 16;
    const int warps = rows * splits;
    const size_t smem = sizeof(uint32_t) * nf * 8 * stride +
                        sizeof(uint4) * warps * kStages * kSlotUint4;
    if (smem <= kMaxSmem) {
      err = allow_decode_smem(batched, vec, nf, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid(static_cast<unsigned>((tiles + rows - 1) / rows), 1,
                      static_cast<unsigned>(e));
      const DecodeKernel kernel = kDecode[batched][vec][nf - 1];
      kernel<<<grid, warps * 32, smem, stream>>>(a, b, out, m, n, kw, splits,
                                                 static_cast<int>(stride));
      return static_cast<int>(cudaGetLastError());
    }
  }
  const dim3 grid(static_cast<unsigned>((n + kPfN - 1) / kPfN),
                  static_cast<unsigned>((m + kPfM - 1) / kPfM),
                  static_cast<unsigned>(e));
  const PrefillKernel kernel = kPrefill[batched][vec];
  kernel<<<grid, kPfThreads, kPfSmem, stream>>>(a, b, out, m, n, kw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_xnor_dot_mxu(const int32_t* a, const int32_t* b,
                                  int32_t* out, long long m, long long n,
                                  long long kw, cudaStream_t stream) {
  return launch(false, a, b, out, 1, m, n, kw, stream);
}

extern "C" int repro_xnor_dot_mxu_batched(const int32_t* a, const int32_t* b,
                                          int32_t* out, long long e,
                                          long long m, long long n,
                                          long long kw, cudaStream_t stream) {
  return launch(true, a, b, out, e, m, n, kw, stream);
}
