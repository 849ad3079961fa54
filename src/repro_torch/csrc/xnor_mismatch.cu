// xnor+popcount GEMM (BMXNet Listing 3): (M, Kw) x (N, Kw) 32-bit words ->
// (M, N) int32 mismatch counts  sum_w popc(a[i, w] ^ b[j, w]),  over exactly
// the Kw words given.  Dispatch forms the exact +-1 dot as
// k_true - 2 * mismatches.  The expert-batched form runs the same tiles over
// a leading expert axis: (E, M, Kw) x (E, N, Kw) -> (E, M, N), one expert
// per blockIdx.z, with 64-bit expert offsets.
//
// Replaces: src/repro/kernels/xnor_gemm.py, xnor_mismatch_pallas
// (_vpu_kernel), the default "vpu" backend (repro_xnor_mismatch); and
// xnor_mismatch_batched_pallas (_vpu_kernel_batched), the MoE expert
// buckets of the "vpu" backend (repro_xnor_mismatch_batched).
//
// Why popcount on the CUDA cores: this is the paper's "vpu" path, XOR and
// popcount on the vector units.  The tensor-core form of the same integer
// function (+-1 int8 fragments into mma) is xnor_dot_mxu.cu, the "mxu"
// path; vpu against mxu is the paper's own comparison, so this kernel keeps
// its algorithm and is made fast as what it is.
//
// Bound on the H100.  One word pair costs an XOR and a popcount, and __popc
// issues at 16 per SM per clock, a quarter of a logic op's rate.  Carry-save
// popcounts cut the popcounts per word pair: a full adder (two LOP3s) folds
// three XOR words into a sum word and a carry word of twice the weight, and
// a tree of four full adders takes 8 words in 4 popcounts (popc8,
// Harley-Seal), half the one-popcount ceiling; the XORs and adders then
// take as long again on the logic pipe (8 + 8 per 8 word pairs at 64 per
// SM per clock).  What bounds each tile:
// - granite decode (M = 4): a call reads 0.13-2 MB of weight words (0.04-0.6
//   us at 3.35 TB/s) and needs well under a microsecond of popcounts, so it
//   is bound by its latencies in a row: the launch, one load round trip
//   (the weight ring's first pieces and the activation words are issued
//   together), the popc8 chain of the warp's pieces and the split-K sum;
// - MoE decode (64 experts x 24 bucket rows, 138 M word pairs an up call):
//   9.6 us of bytes against 16.5 us at the carry-save popcount ceiling;
//   integer issue bounds it;
// - prefill (M 256 / 576): integer issue again, at 16 row pairs per 8 words
//   loaded.
// On the card both run near 16 word pairs per SM per clock: the rate if a
// popcount took four logic-op slots, not the 32 of two separate pipes.
// A deeper carry-save state carried across chunks (Harley-Seal with ones /
// twos words per sum), two weight rows a lane, and prefill blocks that walk
// several weight tiles through one ring were each slower on the card.
//
// Two tiles, chosen in the C entry point from the shapes and the SM count
// (make_plan; kernels/xnor_gemm.py, tile_plan, reads it back):
// - Decode (M <= kDecodeMaxRows; past that in row groups of 32 where the
//   prefill grid would fill under half the SMs): a warp owns 16 weight
//   rows, two lanes per row, each lane words 4h..4h+3 of every 8-word chunk
//   (h = lane / 16), and all the block's activation rows.  A ring slot holds
//   a 16-word piece (two chunks), so a lane's 8 words of a piece meet one
//   activation row in one popc8.  Each weight word is read from device
//   memory once per call, in 16-byte cp.async pieces, through a private
//   ring of kStages slots per warp, into registers; the block's activation
//   rows are staged in shared memory once and read as broadcasts, so each
//   weight word in registers meets all the block's activation words without
//   a reload (at MoE decode every expert word is fetched once, not once per
//   8-row tile).  The block's rows are padded up to a row count MR of 4, 8,
//   16, 24 or 32 (a template argument: the row loop unrolls with no guard,
//   the row sums stay in registers, and the activations are staged
//   piece-major so a row's offset is a constant).  Where N/16 warp tiles
//   cannot fill the SMs (granite q / k / v / o / up / down), the pieces are
//   split among a block's warps and their partials added in shared memory
//   in a fixed order, with no atomics.
// - Prefill: 64 activation rows x 64 weight rows per block of 256 threads,
//   each thread a 4 x 4 grid of int32 sums; both operands' 8-word chunks go
//   through a kStages-deep cp.async ring shared by the block, and each
//   thread holds a chunk of 4 activation rows and of 4 weight rows in
//   registers: 16 popc8 per 16 words loaded.  Staged rows are kPfStride =
//   12 words apart, so the 16-byte loads of 8 lanes hit 32 banks.
// No row is skipped: at 1 bit a zero word means 32 times -1 and mismatches
// every set bit of the other operand, so, unlike in the k-bit kernels
// (kbit_plane_gemm.cu, kbit_mxu_gemm.cu), an all-zero row does not add 0
// and every row is contracted.  Words past Kw are never read: the rings and the
// activation rows zero-fill them, and a zero word against a zero word adds
// no mismatch.  The K-tail bits inside the last word are 0 in both operands
// (core/bitpack.py), so they add none either and no correction exists.
// Integer sums are exact in any order, so every output is the same bits in
// every run.  16-byte cp.async needs Kw % 4 == 0 and 16-byte aligned
// operands; other cases copy word by word.  The entry points refuse (with
// cudaErrorInvalidValue) Kw >= 2^26, where 32 * Kw passes int32, and
// grids past 65535 experts or row blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;           // words per row per prefill ring chunk
constexpr int kPiece = 2 * kChunk;  // words per row per decode ring slot
constexpr int kStages = 3;          // cp.async ring depth
constexpr int kDecodeMaxRows = 32;  // M at or below this runs the decode tile
constexpr int kDecodeWarps = 8;     // warps per decode block, at most
constexpr int kWarpRows = 16;       // weight rows per decode warp
constexpr int kSlotVecs = 2 * 32;   // 16-byte vectors per decode ring slot
constexpr int kPfM = 64;            // prefill block: activation rows
constexpr int kPfN = 64;            //   weight rows
constexpr int kPfThreads = 256;     //   16 x 16 threads of 4 x 4 sums
constexpr int kPfStride = kChunk + 4;  // words per staged prefill row
constexpr size_t kMaxSmem = 232448;  // the most an sm_90 block may opt into
constexpr long long kMaxKw = 1LL << 26;  // 32 * Kw must stay below 2^31
constexpr long long kMaxGridYZ = 65535;
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

// sum_w popc(x_w ^ y_w) over the 8 words of two 16-byte pairs in 4
// popcounts: a carry-save tree of four full adders reduces 7 XOR words of
// weight 1 to one word each of weight 1, 2 and 4 (Harley-Seal); the eighth
// is counted as it is.
__device__ __forceinline__ int popc8(const uint4& x0, const uint4& y0,
                                     const uint4& x1, const uint4& y1) {
  uint32_t s1, c1, s2, c2, s3, c3, s4, c4;
  full_add(x0.x ^ y0.x, x0.y ^ y0.y, x0.z ^ y0.z, s1, c1);
  full_add(x0.w ^ y0.w, x1.x ^ y1.x, x1.y ^ y1.y, s2, c2);
  full_add(s1, s2, x1.z ^ y1.z, s3, c3);
  full_add(c1, c2, c3, s4, c4);
  return __popc(s3) + __popc(x1.w ^ y1.w) + 2 * __popc(s4) + 4 * __popc(c4);
}

// Decode tile for up to MR activation rows (MR in kDecodeRows): a block of
// R x S warps (blockDim.x = 32 * R * S, S = `splits`); warp (r, s) owns
// weight rows n0..n0+15 of row tile r (lane l: row n0 + (l & 15), words
// 4h..4h+3 and 8+4h..8+4h+3 of each piece, h = l >> 4) and the s-th of S
// equal runs of the Kw / 16 pieces; every warp holds the block's activation
// rows (row group blockIdx.y).  Dynamic shared memory: the activations,
// piece-major (piece p of row r at act[(p * MR + r) * 16], rows past M and
// words past Kw zero), so a row's offset within a piece is a constant; then
// the warps' rings (kStages slots of 32 lanes x 2 x 16 bytes each).  After
// the loop a warp's ring holds its partial sums (MR x 16 int32) for the
// split-K sum.
template <int MR>
__device__ __forceinline__ void decode_tile(const uint32_t* __restrict__ a,
                                            const uint32_t* __restrict__ b,
                                            int32_t* __restrict__ out,
                                            long long m, long long n,
                                            long long kw, int splits,
                                            bool vec) {
  extern __shared__ __align__(16) uint4 smem[];
  const long long m0 = static_cast<long long>(blockIdx.y) * kDecodeMaxRows;
  const int rows = static_cast<int>(m - m0 < MR ? m - m0 : MR);
  const int warps = blockDim.x >> 5;
  const long long pieces = (kw + kPiece - 1) / kPiece;
  uint32_t* act = reinterpret_cast<uint32_t*>(smem);
  uint4* ring = smem + pieces * MR * (kPiece / 4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4;
  const int split = warp % splits, tile = warp / splits;
  const long long col =
      (static_cast<long long>(blockIdx.x) * (warps / splits) + tile) *
          kWarpRows + (lane & 15);

  const long long p_lo = pieces * split / splits;
  const int my = static_cast<int>(pieces * (split + 1) / splits - p_lo);
  const uint32_t* brow = b + col * kw;
  const bool row_ok = col < n;
  uint4* slots = ring + warp * kStages * kSlotVecs + lane;
  auto issue = [&](int c) {  // piece c of this warp's run into its slot
    if (c < my) {
      const long long w0 = (p_lo + c) * kPiece + 4 * half;
      uint4* slot = slots + (c % kStages) * kSlotVecs;
      copy_seg(smem_addr(slot), brow, w0, kw, row_ok, vec, b);
      copy_seg(smem_addr(slot + 32), brow, w0 + kChunk, kw, row_ok, vec, b);
    }
    cp_commit();
  };
  // the first weight pieces, then the block's activation words, all in
  // flight together: one round trip
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (long long q = tid; q < pieces * MR * 4; q += blockDim.x) {
    const int s = static_cast<int>(q & 3), r = static_cast<int>((q >> 2) % MR);
    const long long p = (q >> 2) / MR;
    copy_seg(smem_addr(act + 4 * q), a + (m0 + r) * kw, p * kPiece + 4 * s,
             kw, r < rows, vec, a);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  int acc[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) acc[r] = 0;
  for (int c = 0; c < my; ++c) {
    cp_wait<kStages - 2>();  // piece c has landed (this lane's copies)
    issue(c + kStages - 1);  // into the slot piece c - 1 left
    const uint4* slot = slots + (c % kStages) * kSlotVecs;
    const uint4 w0 = slot[0], w1 = slot[32];
    const uint4* ac = reinterpret_cast<const uint4*>(
        act + (p_lo + c) * MR * kPiece) + half;
#pragma unroll
    for (int r = 0; r < MR; ++r)
      acc[r] += popc8(ac[4 * r], w0, ac[4 * r + 2], w1);
  }
  // each row's two halves (lanes l and l ^ 16)
#pragma unroll
  for (int r = 0; r < MR; ++r)
    acc[r] += __shfl_xor_sync(0xFFFFFFFFu, acc[r], 16);

  if (splits == 1) {  // the warp holds whole sums: lane half h stores rows
                      // of parity h
    if (!row_ok) return;
#pragma unroll
    for (int r = 0; r < MR; ++r)
      if (r < rows && (r & 1) == half) out[(m0 + r) * n + col] = acc[r];
    return;
  }
  // split K: each warp's partials into its own ring (its copies have all
  // landed), then the row tile's S partials added in split order
  cp_wait<0>();
  __syncwarp();
  int* red = reinterpret_cast<int*>(ring + warp * kStages * kSlotVecs);
#pragma unroll
  for (int r = 0; r < MR; ++r)
    if ((r & 1) == half) red[r * 16 + (lane & 15)] = acc[r];
  __syncthreads();
  if (!row_ok) return;
  const int* tile_red = reinterpret_cast<const int*>(
      ring + tile * splits * kStages * kSlotVecs) + (lane & 15);
  constexpr int kWarpInts = kStages * kSlotVecs * 4;
  for (int r = split * 2 + half; r < rows; r += 2 * splits) {
    int sum = 0;
    for (int s = 0; s < splits; ++s) sum += tile_red[s * kWarpInts + r * 16];
    out[(m0 + r) * n + col] = sum;
  }
}

// Prefill tile: activation rows m0..m0+63 x weight rows n0..n0+63; thread
// (tm, tn) = (tid / 16, tid % 16) owns activation rows m0 + 4*tm + r and
// weight rows n0 + tn + 16*c, r, c < 4.  A ring stage holds one 8-word
// chunk of the 64 activation rows, then of the 64 weight rows, kPfStride
// words apart.
__device__ __forceinline__ void prefill_tile(const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             int32_t* __restrict__ out,
                                             long long m, long long n,
                                             long long kw, bool vec) {
  __shared__ __align__(16) uint32_t stages[kStages][2 * kPfM * kPfStride];
  const int tid = threadIdx.x, tn = tid & 15, tm = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.y) * kPfM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kPfN;
  const long long chunks = (kw + kChunk - 1) / kChunk;
  auto issue = [&](long long c) {
    if (c < chunks) {
      uint32_t* st = stages[c % kStages];
      for (int q = tid; q < 2 * kPfM * 2; q += kPfThreads) {
        const int sr = q >> 1, s = q & 1;
        const bool is_a = sr < kPfM;  // activation rows first
        const long long gr = (is_a ? m0 : n0) + (sr & (kPfM - 1));
        copy_seg(smem_addr(st + sr * kPfStride + 4 * s),
                 (is_a ? a : b) + gr * kw, c * kChunk + 4 * s, kw,
                 gr < (is_a ? m : n), vec, a);
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
    const uint32_t* sa = stages[c % kStages];
    const uint32_t* sb = sa + kPfM * kPfStride;
    uint4 aw[4][2], bw[4][2];  // the chunk's 8 words of 4 rows each
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        aw[r][h] = *reinterpret_cast<const uint4*>(
            sa + (4 * tm + r) * kPfStride + 4 * h);
        bw[r][h] = *reinterpret_cast<const uint4*>(
            sb + (tn + 16 * r) * kPfStride + 4 * h);
      }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        acc[r][cc] += popc8(aw[r][0], bw[cc][0], aw[r][1], bw[cc][1]);
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

template <int MR>
__global__ void __launch_bounds__(kDecodeWarps * 32)
xnor_mismatch_decode(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                     long long m, long long n, long long kw, int splits,
                     bool vec) {
  decode_tile<MR>(a, b, out, m, n, kw, splits, vec);
}

// blockIdx.z = expert: its (M, Kw), (N, Kw) and (M, N) slabs.
template <int MR>
__global__ void __launch_bounds__(kDecodeWarps * 32)
xnor_mismatch_batched_decode(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             int32_t* __restrict__ out, long long m,
                             long long n, long long kw, int splits, bool vec) {
  const long long e = blockIdx.z;
  decode_tile<MR>(a + e * m * kw, b + e * n * kw, out + e * m * n, m, n, kw,
                  splits, vec);
}

__global__ void __launch_bounds__(kPfThreads, 2)
xnor_mismatch_prefill(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      int32_t* __restrict__ out, long long m, long long n,
                      long long kw, bool vec) {
  prefill_tile(a, b, out, m, n, kw, vec);
}

__global__ void __launch_bounds__(kPfThreads, 2)
xnor_mismatch_batched_prefill(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              int32_t* __restrict__ out, long long m,
                              long long n, long long kw, bool vec) {
  const long long e = blockIdx.z;
  prefill_tile(a + e * m * kw, b + e * n * kw, out + e * m * n, m, n, kw,
               vec);
}

using DecodeKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                              long long, long long, long long, int, bool);
using PrefillKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                               long long, long long, long long, bool);

// the decode tile's row counts (MR): a block's rows padded up to one
constexpr int kDecodeRows[] = {4, 8, 16, 24, 32};
constexpr int kRowCounts = sizeof(kDecodeRows) / sizeof(int);
// [batched][row count]
const DecodeKernel kDecode[2][kRowCounts] = {
    {xnor_mismatch_decode<4>, xnor_mismatch_decode<8>,
     xnor_mismatch_decode<16>, xnor_mismatch_decode<24>,
     xnor_mismatch_decode<32>},
    {xnor_mismatch_batched_decode<4>, xnor_mismatch_batched_decode<8>,
     xnor_mismatch_batched_decode<16>, xnor_mismatch_batched_decode<24>,
     xnor_mismatch_batched_decode<32>}};
const PrefillKernel kPrefill[2] = {xnor_mismatch_prefill,
                                   xnor_mismatch_batched_prefill};

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

// Lets decode kernel [batched][rc] use up to kMaxSmem bytes of dynamic
// shared memory on `dev`, once per kernel and device.
cudaError_t allow_smem(bool batched, int rc, int dev) {
  static bool done[kMaxDevices][2][kRowCounts];
  if (dev < kMaxDevices && done[dev][batched][rc]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kDecode[batched][rc]),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev][batched][rc] = true;
  return err;
}

// The tile an (E,) M x N x Kw call runs on a card with `sms` SMs: the one
// rule that launch() follows and repro_xnor_mismatch_plan reports.
struct Plan {
  bool decode = false;
  long long grid[3] = {0, 0, 0};
  int threads = 0;
  size_t smem = 0;
  // decode only: the index of the least row count that holds the block's
  // rows, its row groups, Kw's pieces, and warps = row_tiles * splits
  int rc = 0;
  long long row_groups = 1, pieces = 0;
  int row_tiles = 0, splits = 0;
};

// cudaErrorInvalidValue for a shape the kernels do not take
cudaError_t make_plan(long long e, long long m, long long n, long long kw,
                      int sms, Plan* p) {
  if (e <= 0 || m <= 0 || n <= 0 || kw < 0 || kw >= kMaxKw || e > kMaxGridYZ)
    return cudaErrorInvalidValue;
  const long long pf_row_blocks = (m + kPfM - 1) / kPfM;
  const long long pf_blocks = (n + kPfN - 1) / kPfN * pf_row_blocks * e;
  const long long row_groups = (m + kDecodeMaxRows - 1) / kDecodeMaxRows;
  if ((m <= kDecodeMaxRows || 2 * pf_blocks < sms) &&
      row_groups <= kMaxGridYZ) {
    // row groups of up to 32 activation rows (one at decode); past 32 rows
    // where the prefill tile's grid would leave most SMs idle
    const long long g_rows = m < kDecodeMaxRows ? m : kDecodeMaxRows;
    const long long tiles = (n + kWarpRows - 1) / kWarpRows;
    const long long pieces = (kw + kPiece - 1) / kPiece;
    const long long units = e * row_groups;  // (expert, row group) pairs
    // split K only until every SM gets a block's worth of warps: a power of
    // two, at most the block's warps, each split at least one piece
    int splits = 1;
    while (splits < kDecodeWarps && 2 * splits <= pieces &&
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
    int rc = 0;
    while (kDecodeRows[rc] < g_rows) ++rc;
    const int warps = row_tiles * splits;
    const size_t smem = sizeof(uint32_t) * kDecodeRows[rc] * pieces * kPiece +
                        sizeof(uint4) * warps * kStages * kSlotVecs;
    if (smem <= kMaxSmem) {
      p->decode = true;
      p->grid[0] = (tiles + row_tiles - 1) / row_tiles;
      p->grid[1] = row_groups;
      p->grid[2] = e;
      p->threads = warps * 32;
      p->smem = smem;
      p->rc = rc;
      p->row_groups = row_groups;
      p->pieces = pieces;
      p->row_tiles = row_tiles;
      p->splits = splits;
      return cudaSuccess;
    }
  }
  if (pf_row_blocks > kMaxGridYZ) return cudaErrorInvalidValue;
  p->grid[0] = (n + kPfN - 1) / kPfN;
  p->grid[1] = pf_row_blocks;
  p->grid[2] = e;
  p->threads = kPfThreads;
  return cudaSuccess;
}

int launch(bool batched, const int32_t* a32, const int32_t* b32, int32_t* out,
           long long e, long long m, long long n, long long kw,
           cudaStream_t stream) {
  if (e <= 0 || m <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  Plan p;
  if (err == cudaSuccess) err = make_plan(e, m, n, kw, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* a = reinterpret_cast<const uint32_t*>(a32);
  const auto* b = reinterpret_cast<const uint32_t*>(b32);
  const bool vec = kw % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(p.grid[0]),
                  static_cast<unsigned>(p.grid[1]),
                  static_cast<unsigned>(p.grid[2]));
  if (p.decode) {
    err = allow_smem(batched, p.rc, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    kDecode[batched][p.rc]<<<grid, p.threads, p.smem, stream>>>(
        a, b, out, m, n, kw, p.splits, vec);
  } else {
    kPrefill[batched]<<<grid, p.threads, 0, stream>>>(a, b, out, m, n, kw,
                                                      vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_xnor_mismatch(const int32_t* a, const int32_t* b,
                                   int32_t* out, long long m, long long n,
                                   long long kw, cudaStream_t stream) {
  return launch(false, a, b, out, 1, m, n, kw, stream);
}

extern "C" int repro_xnor_mismatch_batched(const int32_t* a, const int32_t* b,
                                           int32_t* out, long long e,
                                           long long m, long long n,
                                           long long kw, cudaStream_t stream) {
  return launch(true, a, b, out, e, m, n, kw, stream);
}

// The plan launch() follows for an (E,) M x N x Kw call on a card with `sms`
// SMs, into out[11]: decode (1) or prefill (0), grid x / y / z, threads a
// block, dynamic shared memory, and for the decode tile its row count, row
// groups, row tiles and splits a block, and Kw's 16-word pieces.  Launches
// nothing; returns cudaErrorInvalidValue for a shape the kernels refuse.
extern "C" int repro_xnor_mismatch_plan(long long e, long long m, long long n,
                                        long long kw, int sms,
                                        long long* out) {
  Plan p;
  const cudaError_t err = make_plan(e, m, n, kw, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fields[11] = {
      p.decode, p.grid[0], p.grid[1], p.grid[2], p.threads,
      static_cast<long long>(p.smem), p.decode ? kDecodeRows[p.rc] : 0,
      p.row_groups, p.row_tiles, p.splits, p.pieces};
  for (int i = 0; i < 11; ++i) out[i] = fields[i];
  return 0;
}
